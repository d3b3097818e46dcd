// The engine's remaining datapaths for Hopper: every (input, accumulator,
// output) combination the JAX package's gemm_ref accepts beyond the fifteen
// that gemm.cu, gemm16.cu and conv.cu run in one launch.
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (:81, pallas_call :105),
// gemm_ws (:160, pallas_call :184) and accumulator_epilogue (:230,
// pallas_call :246), and in src/repro/kernels/conv.py conv2d_implicit (:88,
// pallas_call :140), on the combinations those kernels take through
// dot_general's preferred_element_type and epilogue.apply.
//
// XLA's CPU computes dot_general(a, b, preferred_element_type=P) in one
// dtype D (kernels/ref.py product_dtypes): both inputs converted to P where
// their dtypes differ, else the higher of the inputs' dtype and P in XLA's
// precision order (int8 < int16 < int32 < fp16 < bf16 < fp32), the sum
// converted to P. The 171 combinations collapse onto four mechanisms:
//   (a) the product on an existing main loop, chosen by D: bf16 / fp16 on
//       hgemm.cuh, fp32 on sgemm.cuh, int8 / int16 inputs on igemm.cuh
//       (an int8 or int16 sum wrapped to 8 or 16 bits is the int32 sum
//       wrapped, so those loops serve every integer D as wide as the
//       inputs), each writing its wide sum (fp32 or int32);
//   (b) int32 inputs: sgemm.cuh's loop on int32 multiply-adds modulo 2^32
//       (gemm_s32_launch here, conv.cu's IN_I32), sgemm's plan;
//   (c) epilogue_any: the wide sum rounded (floats) or wrapped (integers)
//       to D, converted to P, the bias converted to P and added there,
//       then the plain version's epilogue and cast (epilogue.cuh any_*);
//       accumulator_epilogue runs it on every accumulator dtype;
//   (d) convert: inputs whose dtype is not the main loop's (mixed input
//       dtypes, an int8 input beside an int16 one, a float input of an
//       integer D) converted by XLA's rules first, strided views read
//       through their strides.
// A combination runs as (d) where it needs it, then (a) or (b), then (c):
// two to four launches, each counted. Nothing here is a library call.
//
// What bounds them: (c) and (d) are elementwise, bytes (one read and one
// write of each value at 3.35 TB/s); (b) the INT32 multiply-add rate of the
// CUDA cores (half the fp32 FMA rate).
//
// C interface: convert_launch, epilogue_any_launch, gemm_s32_launch,
// gemm_s32_plan; each launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "sgemm.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  const long long most = 132LL * 16;
  return (unsigned)(b < 1 ? 1 : b < most ? b : most);
}

// dst[i] = convert(src at the i-th index of a (s0, s1, s2, s3) view with
// element strides t0..t3), dst contiguous.
__global__ void __launch_bounds__(THREADS)
convert_kernel(const void* src, int sdt, void* dst, int ddt, long long s1,
               long long s2, long long s3, long long t0, long long t1,
               long long t2, long long t3, long long n) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    long long r = i;
    const long long i3 = r % s3; r /= s3;
    const long long i2 = r % s2; r /= s2;
    const long long i1 = r % s1; r /= s1;
    const long long at = r * t0 + i1 * t1 + i2 * t2 + i3 * t3;
    epi::any_store(dst, i, ddt,
                   epi::any_convert(sdt, ddt, epi::any_load(src, at, sdt)));
  }
}

// C = epilogue(convert(wrap_or_round(W, D), P) + convert(bias, P)) over an
// (M, N) row-major W of dtype wdt; bias: a row (ldd 0) or (M, N) at row
// stride ldd of dtype bdt, or null.
__global__ void __launch_bounds__(THREADS)
epilogue_any_kernel(const void* w, int wdt, int ddt, int adt, const void* bias,
                    int bdt, long long ldd, void* c, int odt, long long n_cols,
                    long long count, int act, int shift, float out_scale) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < count; i += (long long)gridDim.x * THREADS) {
    epi::AnyVal v = epi::any_convert(wdt, ddt, epi::any_load(w, i, wdt));
    v = epi::any_convert(ddt, adt, v);
    if (bias != nullptr) {
      const long long row = i / n_cols, col = i - row * n_cols;
      const epi::AnyVal b = epi::any_convert(
          bdt, adt, epi::any_load(bias, row * ldd + col, bdt));
      v = epi::any_add(adt, v, b);
    }
    epi::any_store(c, i, odt,
                   epi::any_epilogue(adt, odt, v, shift, act, out_scale));
  }
}

}  // namespace

// dst (contiguous, dtype ddt) = XLA's convert of src (dtype sdt) read as a
// 4-D view of sizes (s0, s1, s2, s3) and element strides (t0..t3); dtype
// codes 0 int8, 1 int16, 2 int32, 3 bf16, 4 fp16, 5 fp32.
extern "C" int convert_launch(const void* src, int sdt, void* dst, int ddt,
                              long long s0, long long s1, long long s2,
                              long long s3, long long t0, long long t1,
                              long long t2, long long t3, void* stream) {
  const long long n = s0 * s1 * s2 * s3;
  if (n <= 0) return 0;
  convert_kernel<<<blocks_for(n), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      src, sdt, dst, ddt, s1, s2, s3, t0, t1, t2, t3, n);
  return static_cast<int>(cudaGetLastError());
}

// c (contiguous (count / n_cols, n_cols), dtype odt) = the generic
// epilogue of w (same shape, dtype wdt): w rounded or wrapped to ddt,
// converted to the accumulator adt, + the bias (dtype bdt: a row where ldd
// is 0, else row stride ldd; null: none) in adt, then shift (integer
// accumulators: in [0, 31]; float: out_scale = 2^-shift) and act.
extern "C" int epilogue_any_launch(const void* w, int wdt, int ddt, int adt,
                                   const void* bias, int bdt, long long ldd,
                                   void* c, int odt, long long n_cols,
                                   long long count, int act, int shift,
                                   float out_scale, void* stream) {
  if (count <= 0) return 0;
  epilogue_any_kernel<<<blocks_for(count), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      w, wdt, ddt, adt, bias, bdt, ldd, c, odt, n_cols > 0 ? n_cols : 1,
      count, act, shift, out_scale);
  return static_cast<int>(cudaGetLastError());
}

// int32 inputs: a (M, K) at row stride lda; b (K, N) read as b[k * ldb +
// n], or b[n * ldb + k] when b_trans; d: an int32 bias, row stride ldd (0
// broadcasts one row), or null; c contiguous (M, N): int32 (out_dtype 0),
// int8 (1) or int16 (2), the sums wrapping modulo 2^32; workspace: calls
// whose plan (gemm_s32_plan) splits K, plan[9] 4-byte words owned by the
// stream, else null; tile, splits: the caller's plan (sgemm's tile codes 1,
// 2), or 0, 0 for the call's own.
extern "C" int gemm_s32_launch(const void* a, const void* b, const void* d,
                               void* c, int m, int n, int k, long long lda,
                               long long ldb, int b_trans, long long ldd,
                               int out_dtype, int act, int shift, int ws,
                               void* stream, void* workspace, int tile,
                               int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* A = static_cast<const int*>(a);
  const int* B = static_cast<const int*>(b);
  const int* D = static_cast<const int*>(d);
  if (out_dtype == 1)
    return static_cast<int>(sgemm::launch_gemm<int, int8_t>(
        A, B, D, static_cast<int8_t*>(c), m, n, k, lda, ldb, b_trans, ldd,
        act, shift, 1.f, ws, workspace, s, tile, splits));
  if (out_dtype == 2)
    return static_cast<int>(sgemm::launch_gemm<int, int16_t>(
        A, B, D, static_cast<int16_t*>(c), m, n, k, lda, ldb, b_trans, ldd,
        act, shift, 1.f, ws, workspace, s, tile, splits));
  return static_cast<int>(sgemm::launch_gemm<int, int>(
      A, B, D, static_cast<int*>(c), m, n, k, lda, ldb, b_trans, ldd, act,
      shift, 1.f, ws, workspace, s, tile, splits));
}

// The int32 kernel's plan, as gemm.cu's gemm_plan reports one (plan[0]
// regime 2, the CUDA cores).
extern "C" int gemm_s32_plan(int m, int n, int k, int b_trans, int tile,
                             int splits, long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  sgemm::Plan p;
  if (!sgemm::resolve<int>(m, n, k, b_trans, hgemm::sm_count(), tile, splits,
                           p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out[11] = {2,        p.bm,     p.bn,      p.bk,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, sgemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}
