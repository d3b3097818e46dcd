// The chunked SSD for every call ssd.cu does not take: any head dim, as
// column slices of the compiled widths on the grid's z axis, and N up to
// 256. The kernels, their design and the C interface are in ssd.cuh.
#define SSD_GENERIC true
#include "ssd.cuh"
