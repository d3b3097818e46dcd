// The chunked SSD on fp16 inputs at its compiled head dims (8, 16, 32, 64)
// and N <= 128: ssd_tc_kernel with T = __half, the instances the registry's
// fp16 models run. The kernels, their design and the C interface are in
// ssd.cuh; ssd16_any.cu holds the other fp16 calls.
#define SSD_GENERIC false
#define SSD_HALF true
#include "ssd.cuh"
