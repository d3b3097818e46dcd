// Engine GEMM for Hopper: C = epilogue(A @ B + D), on both dataflows, and
// the explicit mvout epilogue.
//
// Replaces, in src/repro/kernels/gemm.py:
//   gemm_os (_os_kernel)                    -> every launcher here, ws = 0
//   gemm_ws (_ws_kernel)                    -> the same kernels, ws = 1
//   accumulator_epilogue (_epilogue_kernel) -> epilogue_kernel
// The C tile stays in an accumulator (fp32, or int32 for int8 inputs)
// while A and B stream through; D (bias: one row broadcast or a full
// (M, N) matrix) and the epilogue of epilogue.cuh -- activation, rounding
// shift, saturation or rounding to the output type -- are applied once,
// when the tile is stored.
//
// What bounds it on the H100: the serving path's GEMMs are skinny. At
// decode M = 4 (one row per slot), so every weight byte is used four times
// and the call is bound by reading B from device memory (2 bytes per
// weight at 3.35 TB/s). At prefill M = 256..1000 it moves towards the
// tensor-core rate. The design answers the first case: B is read once per
// column strip, in 16-byte vectors, in whatever layout the caller holds it
// -- row-major (K, N) weights, or the tied unembedding's (N, K) table read
// as its transpose without a copy (the table is 604 MB at full width). A
// block with M <= 16 uses a 16-row tile, so a decode call wastes no
// tensor-core work and reads no padding rows.
//
// Inputs: bf16 runs on the tensor cores through nvcuda::wmma bf16
// fragments with fp32 accumulation; fp32 runs on plain FMAs (no TF32), so
// the fp32 engine config stays IEEE; int8 runs on the int8 tensor cores
// (igemm.cuh: mma.sync s8 with a wrapping int32 accumulator, the bias
// preloaded). Ragged M, N and K edges are masked here; callers pass
// operands at their true size.
//
// Dataflows: on the TPU, WS is a weight-major grid (gn, gm, gk) around a
// VMEM accumulator, with the same numerics as OS. Here ws = 1 walks the
// blocks weight-major (all M tiles of one N strip before the next), and
// the int8 kernel also keeps the block's weight strip resident in shared
// memory across its M tiles (igemm.cuh). Every block computes its tile
// the same way in both orders, so WS equals OS bit for bit.
//
// accumulator_epilogue: one elementwise pass over a raw (M, N) int32 or
// fp32 accumulator, bound by its bytes (4 in, 1..4 out per element);
// grid-stride, any shape.
//
// C interface: gemm_launch (bf16 / fp32 inputs), gemm_s8_launch (int8
// inputs), epilogue_launch; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"
#include "igemm.cuh"

using namespace nvcuda;

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { OUT_I32 = 0, OUT_I8 = 1 };

// fp32 epilogue for one output element of a float GEMM: acc + D, then
// epilogue.cuh's activation, shift and rounding.
template <typename OutT>
__device__ __forceinline__ void store(OutT* C, const float* D, long long ldd,
                                      int r, int c, int N, float acc, int act,
                                      float out_scale) {
  if (D != nullptr) acc += D[(long long)r * ldd + c];
  epi::store_float(C, (long long)r * N + c, acc, act, out_scale);
}

// ---------------------------------------------------------------------------
// bf16 inputs: wmma tensor cores, 4 warps, fp32 accumulators.
// Block tile BM x BN, warp tile WM x WN, K step BK.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int WM, int WN, bool TRANS_B, typename OutT>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B,
                 const float* __restrict__ D, OutT* __restrict__ C,
                 int M, int N, int K, long long lda, long long ldb,
                 long long ldd, int act, float out_scale, int vec_a,
                 int vec_b, int ws) {
  static_assert((BM / WM) * (BN / WN) == 4, "four warps per block");
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int APAD = BK + 8;                      // rows stay 16B aligned
  constexpr int BROWS = TRANS_B ? BN : BK;          // Bs as [n][k] or [k][n]
  constexpr int BCOLS = TRANS_B ? BK + 8 : BN + 8;
  constexpr int CPAD = BN + 4;

  __shared__ __align__(32) __nv_bfloat16 As[BM][APAD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BROWS][BCOLS];
  __shared__ __align__(32) float Cs[BM][CPAD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / (BN / WN), wc = warp % (BN / WN);
  // ws: x walks the M tiles of the N strip y (weight-major).
  const int m0 = (ws ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (ws ? blockIdx.y : blockIdx.x) * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK, 8-element (16-byte) chunks along K.
    for (int ch = tid; ch < BM * BK / 8; ch += 128) {
      const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + c8;
      __nv_bfloat16* dst = &As[r][c8];
      if (vec_a && gr < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(A + (long long)gr * lda + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gk + e < K) ? A[(long long)gr * lda + gk + e] : zero;
      }
    }
    if (TRANS_B) {
      // B(k, n) = B[n * ldb + k]: chunks run along K (contiguous there).
      for (int ch = tid; ch < BN * BK / 8; ch += 128) {
        const int nr = ch / (BK / 8), k8 = (ch % (BK / 8)) * 8;
        const int gn = n0 + nr, gk = k0 + k8;
        __nv_bfloat16* dst = &Bs[nr][k8];
        if (vec_b && gn < N && gk + 8 <= K) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(B + (long long)gn * ldb + gk);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (gn < N && gk + e < K) ? B[(long long)gn * ldb + gk + e] : zero;
        }
      }
    } else {
      // B(k, n) = B[k * ldb + n]: chunks run along N.
      for (int ch = tid; ch < BK * BN / 8; ch += 128) {
        const int kr = ch / (BN / 8), n8 = (ch % (BN / 8)) * 8;
        const int gk = k0 + kr, gn = n0 + n8;
        __nv_bfloat16* dst = &Bs[kr][n8];
        if (vec_b && gk < K && gn + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(B + (long long)gk * ldb + gn);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (gk < K && gn + e < N) ? B[(long long)gk * ldb + gn + e] : zero;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[wr * WM + i * 16][kk], APAD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int nc = wc * WN + j * 16;
        if (TRANS_B) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &Bs[nc][kk], BCOLS);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Bs[kk][nc], BCOLS);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[wr * WM + i * 16][wc * WN + j * 16], acc[i][j],
                              CPAD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) store(C, D, ldd, gr, gc, N, Cs[r][c], act, out_scale);
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: 64 x 64 tile, 256 threads, 4 x 4 outputs each, IEEE FMAs.
// ---------------------------------------------------------------------------
template <bool TRANS_B, typename OutT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ D, OutT* __restrict__ C, int M, int N,
                int K, long long lda, long long ldb, long long ldd, int act,
                float out_scale, int ws) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = (ws ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (ws ? blockIdx.y : blockIdx.x) * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      const int gr = m0 + r, gk = k0 + c;
      As[c][r] = (gr < M && gk < K) ? A[(long long)gr * lda + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += 256) {
      int kr, nc;
      if (TRANS_B) { nc = e / BK; kr = e % BK; } else { kr = e / BN; nc = e % BN; }
      const int gk = k0 + kr, gn = n0 + nc;
      float v = 0.f;
      if (gk < K && gn < N)
        v = TRANS_B ? B[(long long)gn * ldb + gk] : B[(long long)gk * ldb + gn];
      Bs[kr][nc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr < M && gc < N) store(C, D, ldd, gr, gc, N, acc[i][j], act, out_scale);
    }
}

// Grid (N tiles, M tiles) in OS order; (M tiles, N tiles) for ws, so that
// consecutive blocks share one weight strip.
inline dim3 tile_grid(int m, int n, int bm, int bn, int ws) {
  const unsigned mt = (m + bm - 1) / bm, nt = (n + bn - 1) / bn;
  return ws ? dim3(mt, nt) : dim3(nt, mt);
}

template <int BM, int BN, int WM, int WN, typename OutT>
void launch_bf16(const void* a, const void* b, const float* d, OutT* c, int m,
                 int n, int k, long long lda, long long ldb, int b_trans,
                 long long ldd, int act, float out_scale, int vec_a, int vec_b,
                 int ws, cudaStream_t s) {
  const dim3 grid = tile_grid(m, n, BM, BN, ws);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
  if (b_trans)
    gemm_bf16_kernel<BM, BN, 32, WM, WN, true, OutT><<<grid, 128, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, vec_a, vec_b, ws);
  else
    gemm_bf16_kernel<BM, BN, 32, WM, WN, false, OutT><<<grid, 128, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, vec_a, vec_b, ws);
}

template <typename OutT>
void launch_typed(const void* a, const void* b, const float* d, OutT* c, int m,
                  int n, int k, long long lda, long long ldb, int b_trans,
                  long long ldd, int in_dtype, int act, float out_scale,
                  int ws, cudaStream_t s) {
  if (in_dtype == DT_BF16) {
    const int vec_a = (lda % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
    const int vec_b = (ldb % 8 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
    if (m <= 16)
      launch_bf16<16, 64, 16, 16, OutT>(a, b, d, c, m, n, k, lda, ldb, b_trans,
                                        ldd, act, out_scale, vec_a, vec_b, ws,
                                        s);
    else
      launch_bf16<64, 64, 32, 32, OutT>(a, b, d, c, m, n, k, lda, ldb, b_trans,
                                        ldd, act, out_scale, vec_a, vec_b, ws,
                                        s);
    return;
  }
  const dim3 grid = tile_grid(m, n, 64, 64, ws);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  if (b_trans)
    gemm_f32_kernel<true, OutT><<<grid, 256, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, ws);
  else
    gemm_f32_kernel<false, OutT><<<grid, 256, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, ws);
}

template <typename AccT, typename OutT>
__global__ void __launch_bounds__(256)
epilogue_kernel(const AccT* __restrict__ acc, OutT* __restrict__ C,
                long long count, int shift, int act, float out_scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < count;
       i += (long long)gridDim.x * 256) {
    if constexpr (std::is_integral<AccT>::value)
      epi::store_int(C, i, acc[i], shift, act);
    else
      epi::store_float(C, i, acc[i], act, out_scale);
  }
}

template <typename AccT, typename OutT>
int launch_epilogue(const void* acc, void* c, long long count, int shift,
                    int act, float out_scale, cudaStream_t s) {
  const long long blocks = std::min<long long>((count + 255) / 256, 132 * 16);
  epilogue_kernel<AccT, OutT><<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const AccT*>(acc), static_cast<OutT*>(c), count, shift, act,
      out_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, K) with row stride lda; b: (K, N) read as b[k * ldb + n], or as
// b[n * ldb + k] when b_trans; d: fp32 bias, row stride ldd (0 broadcasts
// one row), or null; c: contiguous (M, N) output; ws: weight-major order.
extern "C" int gemm_launch(const void* a, const void* b, const void* d, void* c,
                           int m, int n, int k, long long lda, long long ldb,
                           int b_trans, long long ldd, int in_dtype,
                           int out_dtype, int act, float out_scale, int ws,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* D = static_cast<const float*>(d);
  if (out_dtype == DT_BF16)
    launch_typed<__nv_bfloat16>(a, b, D, static_cast<__nv_bfloat16*>(c), m, n,
                                k, lda, ldb, b_trans, ldd, in_dtype, act,
                                out_scale, ws, s);
  else
    launch_typed<float>(a, b, D, static_cast<float*>(c), m, n, k, lda, ldb,
                        b_trans, ldd, in_dtype, act, out_scale, ws, s);
  return static_cast<int>(cudaGetLastError());
}

// int8 inputs, int32 accumulator: a, b as for gemm_launch; d: int32 bias,
// row stride ldd (0 broadcasts one row), or null; c: contiguous (M, N)
// int32 (out_dtype 0) or int8 (1); shift in [0, 31]; ws: weight-stationary.
extern "C" int gemm_s8_launch(const void* a, const void* b, const void* d,
                              void* c, int m, int n, int k, long long lda,
                              long long ldb, int b_trans, long long ldd,
                              int out_dtype, int act, int shift, int ws,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const igemm::MatrixA al{static_cast<const int8_t*>(a), lda, k,
                          (lda % 16 == 0) &&
                              (reinterpret_cast<uintptr_t>(a) % 16 == 0)};
  const int8_t* B = static_cast<const int8_t*>(b);
  const int* D = static_cast<const int*>(d);
  if (out_dtype == OUT_I8)
    return igemm::launch(al, B, ldb, b_trans, D, ldd, static_cast<int8_t*>(c),
                         m, n, k, shift, act, ws, s);
  return igemm::launch(al, B, ldb, b_trans, D, ldd, static_cast<int*>(c), m, n,
                       k, shift, act, ws, s);
}

// acc: contiguous int32 (acc_dtype 0) or fp32 (1) values; c: the same
// count of int32 / int8 (int acc) or fp32 / bf16 (fp32 acc) outputs, by
// out_dtype (0 = int32 or fp32, 1 = int8 or bf16).
extern "C" int epilogue_launch(const void* acc, void* c, long long count,
                               int acc_dtype, int out_dtype, int act,
                               int shift, float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == 0)
    return out_dtype == OUT_I8
               ? launch_epilogue<int, int8_t>(acc, c, count, shift, act,
                                              out_scale, s)
               : launch_epilogue<int, int>(acc, c, count, shift, act,
                                           out_scale, s);
  return out_dtype == DT_BF16
             ? launch_epilogue<float, __nv_bfloat16>(acc, c, count, shift, act,
                                                     out_scale, s)
             : launch_epilogue<float, float>(acc, c, count, shift, act,
                                             out_scale, s);
}
