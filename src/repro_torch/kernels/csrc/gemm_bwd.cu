// The engine GEMM's backward products on bf16 operands (hgemm_bwd.cuh:
// what it replaces, what bounds it and its design), and the plan of every
// 16-bit instantiation; gemm_bwd16.cu builds the fp16 one beside it.
//
// C interface: gemm_bwd_plan (the plan of an (M, N, K) product),
// gemm_bwd_launch (one bf16 product); the launch returns
// cudaGetLastError(), or cudaErrorInvalidValue for a product the kernel
// cannot take (no tensor map, a plan past its limits, no workspace).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hgemm_bwd.cuh"

// plan_out[15]: bm, bn, bk, stages, threads, smem, tiles_m, tiles_n,
// ksteps, dp_tiles, sk_tiles, splits, sk_blocks, grid, workspace_words.
extern "C" int gemm_bwd_plan(int m, int n, int k, long long* plan_out) {
  hgemm_bwd::Plan p;
  if (!hgemm_bwd::plan(m, n, k, hgemm::sm_count(), p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long v[15] = {hgemm_bwd::BM, p.bn, hgemm_bwd::BK, p.stages,
                           hgemm_bwd::THREADS, p.smem, p.tiles_m, p.tiles_n,
                           p.ksteps, p.dp_tiles, p.sk_tiles, p.splits,
                           p.sk_blocks, p.grid, p.ws_words};
  for (int i = 0; i < 15; ++i) plan_out[i] = v[i];
  return 0;
}

// C (m, n) with row stride ldc = A (m, k) @ B (k, n) on bf16 operands,
// written bf16. a_mn: A read M-major (A[k * lda + m]); b_k: B read K-major
// (B[n * ldb + k]). workspace: the plan's workspace_words, the calling
// stream's, its flags 0; null where the plan needs none.
extern "C" int gemm_bwd_launch(const void* a, const void* b, void* c, int m,
                               int n, int k, long long lda, long long ldb,
                               long long ldc, int a_mn, int b_k,
                               void* stream, void* workspace) {
  using T = __nv_bfloat16;
  return static_cast<int>(hgemm_bwd::launch<T>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, lda, ldb, ldc, a_mn, b_k, workspace,
      static_cast<cudaStream_t>(stream)));
}
