// Engine GEMM for Hopper: C = epilogue(A @ B + D).
//
// Replaces: src/repro/kernels/gemm.py gemm_os (the output-stationary Pallas
// kernel, _os_kernel). The C tile stays in an fp32 accumulator while A and
// B stream through; D (bias, fp32, one row broadcast or a full (M, N)
// matrix) and the epilogue -- activation, rounding shift, rounding to the
// output type -- are applied once, when the tile is stored.
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
// the fp32 engine config stays IEEE. Ragged M, N and K edges are masked
// here; callers pass operands at their true size.
//
// C interface: one launcher, gemm_launch; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_GELU = 3, ACT_SILU = 4 };
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_RELU6: return fminf(fmaxf(x, 0.f), 6.f);
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.f + expf(-x));
    default: return x;
  }
}

__device__ __forceinline__ void put(float* c, long long i, float y) { c[i] = y; }
__device__ __forceinline__ void put(__nv_bfloat16* c, long long i, float y) {
  c[i] = __float2bfloat16(y);
}

// Epilogue for one output element: acc + D, activation, shift (a power-of-
// two scale, exact), rounding to the output type.
template <typename OutT>
__device__ __forceinline__ void store(OutT* C, const float* D, long long ldd,
                                      int r, int c, int N, float acc, int act,
                                      float out_scale) {
  if (D != nullptr) acc += D[(long long)r * ldd + c];
  float y = activate(acc, act) * out_scale;
  put(C, (long long)r * N + c, y);
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
                 int vec_b) {
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
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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
                float out_scale) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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

template <int BM, int BN, int WM, int WN, typename OutT>
void launch_bf16(const void* a, const void* b, const float* d, OutT* c, int m,
                 int n, int k, long long lda, long long ldb, int b_trans,
                 long long ldd, int act, float out_scale, int vec_a, int vec_b,
                 cudaStream_t s) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
  if (b_trans)
    gemm_bf16_kernel<BM, BN, 32, WM, WN, true, OutT><<<grid, 128, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, vec_a, vec_b);
  else
    gemm_bf16_kernel<BM, BN, 32, WM, WN, false, OutT><<<grid, 128, 0, s>>>(
        A, B, d, c, m, n, k, lda, ldb, ldd, act, out_scale, vec_a, vec_b);
}

template <typename OutT>
void launch_typed(const void* a, const void* b, const float* d, OutT* c, int m,
                  int n, int k, long long lda, long long ldb, int b_trans,
                  long long ldd, int in_dtype, int act, float out_scale,
                  cudaStream_t s) {
  if (in_dtype == DT_BF16) {
    const int vec_a = (lda % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
    const int vec_b = (ldb % 8 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
    if (m <= 16)
      launch_bf16<16, 64, 16, 16, OutT>(a, b, d, c, m, n, k, lda, ldb, b_trans,
                                        ldd, act, out_scale, vec_a, vec_b, s);
    else
      launch_bf16<64, 64, 32, 32, OutT>(a, b, d, c, m, n, k, lda, ldb, b_trans,
                                        ldd, act, out_scale, vec_a, vec_b, s);
    return;
  }
  dim3 grid((n + 63) / 64, (m + 63) / 64);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  if (b_trans)
    gemm_f32_kernel<true, OutT><<<grid, 256, 0, s>>>(A, B, d, c, m, n, k, lda,
                                                     ldb, ldd, act, out_scale);
  else
    gemm_f32_kernel<false, OutT><<<grid, 256, 0, s>>>(A, B, d, c, m, n, k, lda,
                                                      ldb, ldd, act, out_scale);
}

}  // namespace

// a: (M, K) with row stride lda; b: (K, N) read as b[k * ldb + n], or as
// b[n * ldb + k] when b_trans; d: fp32 bias, row stride ldd (0 broadcasts
// one row), or null; c: contiguous (M, N) output.
extern "C" int gemm_launch(const void* a, const void* b, const void* d, void* c,
                           int m, int n, int k, long long lda, long long ldb,
                           int b_trans, long long ldd, int in_dtype,
                           int out_dtype, int act, float out_scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* D = static_cast<const float*>(d);
  if (out_dtype == DT_BF16)
    launch_typed<__nv_bfloat16>(a, b, D, static_cast<__nv_bfloat16*>(c), m, n,
                                k, lda, ldb, b_trans, ldd, in_dtype, act,
                                out_scale, s);
  else
    launch_typed<float>(a, b, D, static_cast<float*>(c), m, n, k, lda, ldb,
                        b_trans, ldd, in_dtype, act, out_scale, s);
  return static_cast<int>(cudaGetLastError());
}
