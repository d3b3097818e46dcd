// The flash and paged prefill kernels for every call attention.cu does not
// take: a head dim between the compiled ones (the next instance, its
// columns past the head dim zero-filled) or above 256 (fp32's instance at
// 512), and rows that are not whole aligned 16-byte words
// (element-by-element loads). The kernels, their design and the C
// interface are in attention.cuh; attention_decode_any.cu holds decode's.
#define ATTENTION_GENERIC true
#define ATTENTION_FAMILIES 1
#include "attention.cuh"
