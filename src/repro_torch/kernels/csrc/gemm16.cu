// Engine GEMM for Hopper on the 16-bit datapaths: fp16 inputs (fp32
// accumulator; fp32, bf16 or fp16 out) and int16 inputs (wrapping int32
// accumulator; int32, int8 or int16 out), C = epilogue(A @ B + D), on both
// dataflows.
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (_os_kernel, :81,
// pallas_call :105) and gemm_ws (_ws_kernel, :160, pallas_call :184) for
// fp16 and int16 inputs (an fp16 or int16 Gemmini instance of the dtype
// table).
//
// fp16 runs hgemm.cuh's kernels instantiated for __half: the plan (split-K
// mma.sync for M <= 16, wgmma fed by TMA above) is bf16's, a function of
// the shape alone, and mma.sync / wgmma take .f16 operands at the same
// shapes, so the bound is the same tensor-core rate (989 TFLOP/s dense)
// and bytes. int16 runs igemm.cuh's int8 tensor-core loop on byte planes
// (Hopper has no int16 MMA): each operand splits into a signed high and an
// unsigned low byte, and four mma.sync m16n8k32 products, combined with
// shifts on unsigned words, give the wrapped int32 sum exactly, as the
// plain version and the TPU kernel's int32 dot do; so the bound is the
// int8 tensor rate over four products (1979 / 4 TOP/s). The plan is the
// int8 kernel's, the k geometry in bytes (igemm::plan_here, es = 2):
// 16 x 64 tiles for M <= 16, else 64 x 64, K split by its waves model.
// Both inputs take the tiles and K splits of their plan in either order,
// so WS (weight-major tile order) equals OS bit for bit.
//
// gemm.cu keeps the int8, bf16 and fp32 inputs, gemm_plan (every input's
// plan) and the mvout epilogue; this source is apart so that its build
// runs beside gemm.cu's, not after it.
//
// C interface: gemm_f16_launch, gemm_s16_launch; each returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "hgemm.cuh"
#include "igemm.cuh"

namespace {

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };    // float outputs

template <typename OutT>
int launch_f16(const void* a, const void* b, const void* d, void* c, int m,
               int n, int k, long long lda, long long ldb, int b_trans,
               long long ldd, int act, float out_scale, int ws,
               void* workspace, cudaStream_t s, int tile, int splits) {
  return static_cast<int>(hgemm::launch<__half, OutT>(
      static_cast<const __half*>(a), static_cast<const __half*>(b),
      static_cast<const float*>(d), static_cast<OutT*>(c), m, n, k, lda, ldb,
      b_trans, ldd, act, out_scale, ws, workspace, s, tile, splits));
}

}  // namespace

// fp16 inputs: a: (M, K) with row stride lda; b: (K, N) read as b[k * ldb
// + n], or as b[n * ldb + k] when b_trans; d: fp32 bias, row stride ldd (0
// broadcasts one row), or null; c: contiguous (M, N) fp32 (out_dtype 0),
// bf16 (1) or fp16 (2); ws: weight-major order; workspace: inputs whose
// plan (gemm_plan, in_dtype 2) splits K, its plan[9] 4-byte words owned by
// the stream, else null; tile, splits: the caller's plan (gemm_plan's tile
// codes), or 0, 0 for the call's own.
extern "C" int gemm_f16_launch(const void* a, const void* b, const void* d,
                               void* c, int m, int n, int k, long long lda,
                               long long ldb, int b_trans, long long ldd,
                               int out_dtype, int act, float out_scale,
                               int ws, void* stream, void* workspace,
                               int tile, int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == DT_BF16)
    return launch_f16<__nv_bfloat16>(a, b, d, c, m, n, k, lda, ldb, b_trans,
                                     ldd, act, out_scale, ws, workspace, s,
                                     tile, splits);
  if (out_dtype == DT_F16)
    return launch_f16<__half>(a, b, d, c, m, n, k, lda, ldb, b_trans, ldd,
                              act, out_scale, ws, workspace, s, tile, splits);
  return launch_f16<float>(a, b, d, c, m, n, k, lda, ldb, b_trans, ldd, act,
                           out_scale, ws, workspace, s, tile, splits);
}

// int16 inputs: a, b as for gemm_f16_launch; d: int32 bias, row stride ldd
// (0 broadcasts one row), or null; c: contiguous (M, N) int32 (out_dtype
// 0), int8 (1) or int16 (2); shift in [0, 31]; workspace: inputs whose plan
// (gemm_plan, in_dtype 3) splits K, its plan[9] 4-byte words owned by the
// stream, else null; tile, splits: as for gemm_f16_launch.
extern "C" int gemm_s16_launch(const void* a, const void* b, const void* d,
                               void* c, int m, int n, int k, long long lda,
                               long long ldb, int b_trans, long long ldd,
                               int out_dtype, int act, int shift, int ws,
                               void* stream, void* workspace, int tile,
                               int splits) {
  // A as bytes: rows of 2 K bytes at a stride of 2 lda
  const int8_t* A = static_cast<const int8_t*>(a);
  const igemm::MatrixA al{A, 2 * lda, m, 2 * k, igemm::granule(A, 2 * lda)};
  return static_cast<int>(igemm::launch<int16_t>(
      al, static_cast<const int16_t*>(b), ldb, b_trans,
      static_cast<const int*>(d), ldd, c, out_dtype, m, n, k, shift, 1.f, act,
      ws, workspace, static_cast<cudaStream_t>(stream), 0, tile, splits));
}
