// The engine GEMM's backward products on fp16 operands: hgemm_bwd.cuh's
// kernel instantiated for __half (bf16's plan and code, the .f16 wgmma),
// a source of its own so that its build runs beside gemm_bwd.cu's. The
// plan is gemm_bwd.cu's gemm_bwd_plan.
//
// C interface: gemm_bwd_f16_launch, as gemm_bwd.cu's gemm_bwd_launch.

#include <cuda_runtime.h>
#include <cuda_fp16.h>

#include "hgemm_bwd.cuh"

extern "C" int gemm_bwd_f16_launch(const void* a, const void* b, void* c,
                                   int m, int n, int k, long long lda,
                                   long long ldb, long long ldc, int a_mn,
                                   int b_k, void* stream, void* workspace) {
  using T = __half;
  return static_cast<int>(hgemm_bwd::launch<T>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, lda, ldb, ldc, a_mn, b_k, workspace,
      static_cast<cudaStream_t>(stream)));
}
