// The chunked SSD on fp16 inputs for every call ssd16.cu does not take: any
// head dim, as column slices of the compiled widths on the grid's z axis,
// and N up to 256. The kernels, their design and the C interface are in
// ssd.cuh.
#define SSD_GENERIC true
#define SSD_HALF true
#include "ssd.cuh"
