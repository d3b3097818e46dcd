// The attention kernels at their compiled head dims (16, 32, 64, 128,
// 256), one dtype, on whole aligned 16-byte rows: the instances every
// model of the registry runs. The kernels, their design and the C
// interface are in attention.cuh; attention_any.cu holds the other calls.
#define ATTENTION_GENERIC false
#include "attention.cuh"
