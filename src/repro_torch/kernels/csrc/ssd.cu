// The chunked SSD at its compiled head dims (8, 16, 32, 64) and N <= 128:
// the instances every model of the registry runs. The kernels, their
// design and the C interface are in ssd.cuh; ssd_any.cu holds the other
// calls.
#define SSD_GENERIC false
#include "ssd.cuh"
