// The fp32 flash and paged prefill kernels for every call attention.cu does
// not take: a head dim between the compiled ones (the next instance, its
// columns past the head dim zero-filled) or above 128 (column slices of
// the 128 instance), and rows that are not whole aligned 16-byte words
// (element-by-element loads). The kernels, their design and the C
// interface are in attention.cuh; attention_wg.cu / attention_wg16.cu hold
// the 16-bit calls', attention_decode_any.cu decode's.
#define ATTENTION_GENERIC true
#define ATTENTION_FAMILIES 1
#include "attention.cuh"
