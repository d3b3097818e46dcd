// Chunked Mamba-2 SSD (state-space duality) for Hopper.
//
// Replaces src/repro/kernels/mamba2.py ssd (_ssd_kernel). For each
// (batch, head) the sequence is cut into chunks of Q <= 256 tokens, and per
// chunk, with seg = cumsum(dt * a) and a = -exp(a_log):
//   y_i  = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j     intra-chunk
//        + exp(seg_i) (C_i @ S)                                     carried state
//        + d_skip x_i                                               residual
//   S    = exp(seg_last) S + sum_j exp(seg_last - seg_j) dt_j B_j^T x_j
// Head h reads B/C group h / (H / G). On the TPU the chunk axis is a
// sequential grid dimension carrying S in VMEM scratch, starting from
// zeros; here one block per (head, batch) walks its chunks in a loop with
// S resident in shared memory, loaded from the caller's initial state (a
// resumed prefill chunk) or zeroed. The final S is written on request.
//
// What bounds it on the H100, and what the design does about it: fp32
// CUDA-core operations (the intra-chunk Q x Q x N scores and the Q x Q x P
// product dominate; the inputs are a few bytes per FMA). The chunk is
// processed in 64-row tiles: a tile of C rows stays in shared memory while
// 64-row tiles of B and x stream past it (the whole chunk's 256 x 256
// decay matrix, 256 KB in fp32, would not fit), scores are 4 x 4 register
// micro-tiles, and tiles past the causal diagonal are never computed. The
// decay mask is applied before exp, so i < j never overflows. Ragged
// chunks (the last one, or T < Q) are handled by row predicates, never by a
// padded copy; x, B, C and dt are read through their strides (the model's
// views into its fused projection). A single request gives only B * H
// blocks (64 for mamba2-1.3b) on 132 SMs: occupancy is the known limit of
// this first version, as is the use of CUDA cores instead of tensor cores.
//
// Head dims P in {8, 16, 32, 64} are compiled; the state size N <= 128
// and Q <= 256 are runtime values. x, B, C are fp32 or bf16 (one type),
// dt, a_log, d_skip and the states fp32; y comes out in x's type.
//
// C interface: ssd_launch, returning cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;      // rows of a chunk per tile (outputs and keys)
constexpr int QMAX = 256;     // longest chunk
constexpr int NMAX = 128;     // largest state size
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct SsdArgs {
  const void* x; long long xsb, xst, xsh;    // (B, T, H, P), strides in elements
  const float* dt; long long dsb, dst, dsh;  // (B, T, H)
  const float* a_log;                        // (H,)
  const float* d_skip;                       // (H,)
  const void* b; long long bsb, bst, bsg;    // (B, T, G, N)
  const void* c; long long csb, cst, csg;
  const float* init;                         // (B, H, N, P) or null (zeros)
  void* y;                                   // (B, T, H, P) contiguous
  float* fin;                                // (B, H, N, P) or null
  int T, H, G, N, chunk;
};

// Shared floats for a state size n and head dim P.
__host__ __device__ constexpr int smem_floats(int n, int P) {
  return n * P + 2 * TILE * (n | 1) + TILE * P + TILE * (TILE + 1) + 2 * QMAX;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(SsdArgs p) {
  constexpr int RSTEP = THREADS / P;          // rows between a thread's outputs
  constexpr int OUT = TILE * P / THREADS;     // outputs per thread in a tile
  constexpr int SE = NMAX * P / THREADS;      // state elements per thread (max)
  constexpr int WS = TILE + 1;                // row stride of the weight tile
  const int N = p.N, NS = p.N | 1;            // odd row stride: no bank conflicts
  extern __shared__ float sm[];
  float* S = sm;                              // [N][P] the running state
  float* Cs = S + N * P;                      // [TILE][NS] C rows of the tile
  float* Bs = Cs + TILE * NS;                 // [TILE][NS] B rows (key tile)
  float* Xs = Bs + TILE * NS;                 // [TILE][P]  x rows (key tile)
  float* W = Xs + TILE * P;                   // [TILE][WS] masked weights
  float* seg = W + TILE * WS;                 // [QMAX] cumulative dt * a
  float* dtc = seg + QMAX;                    // [QMAX] the chunk's dt

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float a = -expf(p.a_log[h]);
  const float dsk = p.d_skip[h];
  const T* x = static_cast<const T*>(p.x) + bb * p.xsb + h * p.xsh;
  const float* dtp = p.dt + bb * p.dsb + h * p.dsh;
  const T* bp = static_cast<const T*>(p.b) + bb * p.bsb + g * p.bsg;
  const T* cp = static_cast<const T*>(p.c) + bb * p.csb + g * p.csg;
  T* y = static_cast<T*>(p.y) + ((long long)bb * p.T * p.H + h) * P;
  const long long ystride = (long long)p.H * P;
  const long long soff = ((long long)bb * p.H + h) * N * P;

  for (int e = tid; e < N * P; e += THREADS)
    S[e] = p.init ? p.init[soff + e] : 0.f;

  const int pc = tid % P;                     // this thread's channel
  const int rbase = tid / P;                  // its first row / state row
  const int tr = tid / 16, tc = tid % 16;     // 4 x 4 score micro-tile

  for (int t0 = 0; t0 < p.T; t0 += p.chunk) {
    const int q = min(p.chunk, p.T - t0);
    __syncthreads();                          // last chunk is done with dtc/seg/S
    for (int i = tid; i < q; i += THREADS) dtc[i] = dtp[(long long)(t0 + i) * p.dst];
    __syncthreads();
    if (tid == 0) {
      // In order and without FMA contraction: the rounding of seg is that
      // of the reference's product-then-cumsum, and exp(seg_i - seg_j)
      // turns any difference in it into a relative error of the result.
      float s = 0.f;
      for (int i = 0; i < q; ++i) {
        s = __fadd_rn(s, __fmul_rn(dtc[i], a));
        seg[i] = s;
      }
    }
    __syncthreads();
    const float seg_last = seg[q - 1];

    // -- outputs, one 64-row tile at a time ---------------------------------
    for (int i0 = 0; i0 < q; i0 += TILE) {
      const int ni = min(TILE, q - i0);
      __syncthreads();                        // Cs / W readers of the last tile
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Cs[r * NS + n] = r < ni ? ld(cp + (long long)(t0 + i0 + r) * p.cst + n) : 0.f;
      }
      __syncthreads();

      // carried-state term with S from before this chunk's update
      float acc[OUT];
#pragma unroll
      for (int k = 0; k < OUT; ++k) acc[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s = S[n * P + pc];
#pragma unroll
        for (int k = 0; k < OUT; ++k)
          acc[k] = fmaf(Cs[(rbase + k * RSTEP) * NS + n], s, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < OUT; ++k) {
        const int r = rbase + k * RSTEP;
        acc[k] = r < ni ? acc[k] * expf(seg[i0 + r]) : 0.f;
      }

      // intra-chunk term over the key tiles on or before the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int nj = min(TILE, q - j0);
        __syncthreads();                      // Bs / Xs / W readers are done
        for (int e = tid; e < TILE * N; e += THREADS) {
          const int r = e / N, n = e % N;
          Bs[r * NS + n] = r < nj ? ld(bp + (long long)(t0 + j0 + r) * p.bst + n) : 0.f;
        }
        for (int e = tid; e < TILE * P; e += THREADS) {
          const int r = e / P, pp = e % P;
          Xs[e] = r < nj ? ld(x + (long long)(t0 + j0 + r) * p.xst + pp) : 0.f;
        }
        __syncthreads();
        float s4[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s4[u][v] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cr[u] = Cs[(tr * 4 + u) * NS + n];
#pragma unroll
          for (int v = 0; v < 4; ++v) br[v] = Bs[(tc + 16 * v) * NS + n];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s4[u][v] = fmaf(cr[u], br[v], s4[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + tr * 4 + u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + tc + 16 * v;
            float w = 0.f;
            if (i < q && j <= i)              // mask before exp
              w = s4[u][v] * expf(seg[i] - seg[j]) * dtc[j];
            W[(tr * 4 + u) * WS + tc + 16 * v] = w;
          }
        }
        __syncthreads();
        for (int cc = 0; cc < nj; ++cc) {
          const float xv = Xs[cc * P + pc];
#pragma unroll
          for (int k = 0; k < OUT; ++k)
            acc[k] = fmaf(W[(rbase + k * RSTEP) * WS + cc], xv, acc[k]);
        }
      }

#pragma unroll
      for (int k = 0; k < OUT; ++k) {
        const int r = rbase + k * RSTEP;
        if (r < ni) {
          const long long t = t0 + i0 + r;
          const float xv = ld(x + t * p.xst + pc);
          st(y + t * ystride + pc, acc[k] + dsk * xv);
        }
      }
    }

    // -- state update: S = exp(seg_last) S + sum_j w_j B_j^T x_j ------------
    float ds[SE];
#pragma unroll
    for (int k = 0; k < SE; ++k) ds[k] = 0.f;
    for (int j0 = 0; j0 < q; j0 += TILE) {
      const int nj = min(TILE, q - j0);
      __syncthreads();                        // every output tile read S, Bs, Xs
      if (tid < TILE)
        W[tid] = tid < nj ? expf(seg_last - seg[j0 + tid]) * dtc[j0 + tid] : 0.f;
      __syncthreads();
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Bs[r * NS + n] =
            r < nj ? ld(bp + (long long)(t0 + j0 + r) * p.bst + n) * W[r] : 0.f;
      }
      for (int e = tid; e < TILE * P; e += THREADS) {
        const int r = e / P, pp = e % P;
        Xs[e] = r < nj ? ld(x + (long long)(t0 + j0 + r) * p.xst + pp) : 0.f;
      }
      __syncthreads();
      for (int cc = 0; cc < nj; ++cc) {
        const float xv = Xs[cc * P + pc];
#pragma unroll
        for (int k = 0; k < SE; ++k) {
          const int n = rbase + k * RSTEP;
          if (n < N) ds[k] = fmaf(Bs[cc * NS + n], xv, ds[k]);
        }
      }
    }
    const float dec = expf(seg_last);
#pragma unroll
    for (int k = 0; k < SE; ++k) {
      const int n = rbase + k * RSTEP;
      if (n < N) S[n * P + pc] = S[n * P + pc] * dec + ds[k];
    }
  }

  if (p.fin) {
    __syncthreads();
    for (int e = tid; e < N * P; e += THREADS) p.fin[soff + e] = S[e];
  }
}

template <int P, typename T>
cudaError_t launch(const SsdArgs& a, int batch, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(NMAX, P)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = sizeof(float) * smem_floats(a.N, P);
  dim3 grid(a.H, batch);
  ssd_kernel<P, T><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int P, const SsdArgs& a, int batch, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8, T>(a, batch, s);
    case 16: return launch<16, T>(a, batch, s);
    case 32: return launch<32, T>(a, batch, s);
    case 64: return launch<64, T>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssd_launch(
    const void* x, long long xsb, long long xst, long long xsh,
    const float* dt, long long dsb, long long dst, long long dsh,
    const float* a_log, const float* d_skip,
    const void* b, long long bsb, long long bst, long long bsg,
    const void* c, long long csb, long long cst, long long csg,
    const float* init, void* y, float* fin, int B, int T, int H, int G, int N,
    int P, int chunk, int dtype, void* stream) {
  if (N < 1 || N > NMAX || chunk < 1 || chunk > QMAX || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  SsdArgs a{};
  a.x = x; a.xsb = xsb; a.xst = xst; a.xsh = xsh;
  a.dt = dt; a.dsb = dsb; a.dst = dst; a.dsh = dsh;
  a.a_log = a_log; a.d_skip = d_skip;
  a.b = b; a.bsb = bsb; a.bst = bst; a.bsg = bsg;
  a.c = c; a.csb = csb; a.cst = cst; a.csg = csg;
  a.init = init; a.y = y; a.fin = fin;
  a.T = T; a.H = H; a.G = G; a.N = N; a.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)by_dim<__nv_bfloat16>(P, a, B, s);
  return (int)by_dim<float>(P, a, B, s);
}
