// The dense and paged decode kernels for every call attention.cu does not
// take: a head dim between the compiled ones or above 256 (fp32's
// instance at 512), and rows that are not whole aligned 16-byte words. The
// kernels, their design and the C interface are in attention.cuh;
// attention_any.cu holds flash's and paged prefill's.
#define ATTENTION_GENERIC true
#define ATTENTION_FAMILIES 2
#include "attention.cuh"
