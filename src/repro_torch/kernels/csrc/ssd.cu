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
// sequential grid dimension carrying S in VMEM scratch from zeros; here S
// starts from the caller's initial state (a resumed prefill chunk) or
// zeros, and the final S is written on request.
//
// bf16 inputs (the serving dtype) run ssd_tc_kernel: tensor cores, one
// launch per chunk, the work of a chunk spread over the card. Serving
// prefills in chunks of <= 256 tokens with a carried state, so a call is
// one chunk: at mamba2-1.3b's widths (H = 64, P = 64, N = 128, G = 1) a
// 256-token chunk is ~0.8 GFLOP over ~8 MB (x, y, the state in and out),
// which the H100 moves in ~2.5 us; one block per (head, batch), as the
// first version ran, left over half the SMs idle. The grid holds two kinds
// of 128-thread blocks:
//  * output blocks, one per (64-row tile of the chunk, pair of heads of
//    one B/C group, batch row); each warp owns 16 rows. Its first loads
//    (the C tile, both heads' carried states, dt) are in flight at once;
//    the carried term C_i @ S runs first and is scaled by exp(seg_i) per
//    row. Then the key tiles at or before the row tile stream through two
//    stages (the next one loading while one is computed). The scores
//    C_i B_j^T of a (row tile, key tile) are computed once for both heads
//    (bf16 operands, exact products, fp32 sums) and weighted per head by
//    exp(seg_i - seg_j) dt_j. Below the diagonal tile the decay factors as
//    exp(seg_i - seg_e) exp(seg_e - seg_j), e the key tile's last row,
//    both exponents <= 0, so the exponentials are per row and per column
//    (once per block) instead of per pair; on the diagonal tile each pair
//    is masked before its exponential, and a warp skips the keys past its
//    last row. The blocks are issued longest row tile first.
//  * state blocks, one per (64-row slice of N, head, batch row), only when
//    a state is asked for: S_out = exp(seg_last) S_in + (B * w)^T X over the
//    chunk's rows; where N is under 64 the block's warps split the rows of
//    the chunk instead and reduce in a fixed order.
// All products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate). The
// operands that are fp32 by definition are split into bf16 terms that sum
// to them: the weights (C B^T * L * dt) and the carried S into two terms
// (~16 mantissa bits; they reach y, which is bf16), B * w of the state
// update into three (~24 bits; the state is fp32 and held against an fp64
// recurrence). seg is a warp's scan over the chunk (within a lane in
// order, across lanes by shuffles), without FMA contraction. A longer
// sequence runs chunk after chunk, one launch each, the state carried in
// a two-buffer scratch: serving never makes such a call, and each launch
// still fills the card.
//
// What bounds it now is latency, not bytes or operations: at mamba2-1.3b's
// serving call (256 blocks, 8 warps an SM) the longest output block spends
// ~6.5 us on its first loads, ~5.5 us on the carried term and ~3 us on
// each key tile (globaltimer stamps per phase on an H100, PERF.md), each a
// chain of dependent MMAs and loads with two warps per scheduler to hide
// it. More warps in flight (wgmma, or more rows per block) is the next
// step.
//
// fp32 inputs (the fp32 gate and logits checks) keep ssd_kernel, the first
// version: one block per (head, batch) walks its chunks with S resident in
// shared memory, 4 x 4 fp32 register micro-tiles on the CUDA cores (IEEE
// fp32, which the tensor cores do not offer), tiles past the causal
// diagonal skipped.
//
// Both read x, B, C and dt through their strides (the model's views into
// its fused projection; the bf16 kernel copies 16-byte rows with cp.async
// where the views allow it, else element by element) and handle ragged
// chunks with row predicates, never a padded copy. Head dims P in {8, 16,
// 32, 64} are compiled; N <= 128 and Q <= 256 are runtime values. dt,
// a_log, d_skip and the states are fp32; y comes out in x's type.
//
// C interface: ssd_launch, returning cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 256;     // longest chunk
constexpr int NMAX = 128;     // largest state size
enum { DT_F32 = 0, DT_BF16 = 1 };

// ---------------------------------------------------------------------------
// fp32: ssd_kernel, one block per (head, batch) on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int TILE = 64;      // rows of a chunk per tile (outputs and keys)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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

template <int P>
__global__ void __launch_bounds__(THREADS) ssd_kernel(SsdArgs p) {
  using T = float;
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

template <int P>
cudaError_t launch(const SsdArgs& a, int batch, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(NMAX, P)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = sizeof(float) * smem_floats(a.N, P);
  dim3 grid(a.H, batch);
  ssd_kernel<P><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t by_dim(int P, const SsdArgs& a, int batch, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8>(a, batch, s);
    case 16: return launch<16>(a, batch, s);
    case 32: return launch<32>(a, batch, s);
    case 64: return launch<64>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: ssd_tc_kernel, one chunk per launch on tensor cores.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TC_THREADS = 128;   // 4 warps
constexpr int RT = 64;            // chunk rows per output block, 16 a warp
constexpr int NSL = 64;           // state rows (of N) per state block
constexpr int LDB = NSL + 8;      // bf16 row of a state block's B slice

struct TcArgs {
  const bf16* x; long long xsb, xst, xsh;    // (B, T, H, P), in elements
  const float* dt; long long dsb, dst, dsh;  // (B, T, H)
  const float* a_log;                        // (H,)
  const float* d_skip;                       // (H,)
  const bf16* b; long long bsb, bst, bsg;    // (B, T, G, N)
  const bf16* c; long long csb, cst, csg;
  const float* s_in;                         // (B, H, N, P) or null (zeros)
  float* s_out;                              // (B, H, N, P) or null (none)
  bf16* y;                                   // (B, T, H, P) contiguous
  int T, H, G, N;
  int t0, q;                                 // this chunk: rows [t0, t0 + q)
  int n_rt, n_hs, n_ns;                      // row tiles, head pairs, N slices
  int n_yblk;                                // output blocks per batch row
  int vec;                                   // 16-byte rows: cp.async
};

// Per head dim: x tiles are padded to 16 columns (two n8 MMA tiles); rows
// of bf16 tiles carry 16 spare bytes and fp32 state rows 16, so the rows
// an ldmatrix or a fragment load touches fall in distinct banks.
template <int P>
struct TcShape {
  static constexpr int PP = P < 16 ? 16 : P;
  static constexpr int NT = PP / 8;          // n8 tiles over the head dim
  static constexpr int LDP = PP + 8;         // bf16 row of an x tile
  static constexpr int LDS = PP + 4;         // fp32 row of a state tile
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// Output block: dt, seg and column factors of two heads, the C tile, then one region that
// holds first both heads' carried states and then two stages of key tiles
// (B and both heads' x). State block: dt, the weights, the chunk's B slice
// and x, the row split's partials.
template <int P>
__host__ __device__ constexpr int out_stage_bytes(int n) {
  return RT * (round16(n) + 8) * 2 + 2 * RT * TcShape<P>::LDP * 2;
}
template <int P>
__host__ __device__ constexpr int out_region_bytes(int n) {
  return 2 * out_stage_bytes<P>(n) > 2 * round16(n) * TcShape<P>::LDS * 4
             ? 2 * out_stage_bytes<P>(n)
             : 2 * round16(n) * TcShape<P>::LDS * 4;
}
template <int P>
__host__ __device__ constexpr int tc_smem_bytes(int n) {
  using S = TcShape<P>;
  const int out = 6 * QMAX * 4 + RT * (round16(n) + 8) * 2 +
                  out_region_bytes<P>(n);
  const int state = 2 * QMAX * 4 + 16 + QMAX * LDB * 2 + QMAX * S::LDP * 2 +
                    4 * 16 * S::PP * 4;
  return out > state ? out : state;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; ok = false writes zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) as a bf16 pair hi plus the pair of what rounding left, lo.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
// (x, y) as three bf16 pairs hi + mid + lo.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// rows x cols of a bf16 tile into shared memory (row stride ld) from rows
// rs elements apart; rows >= live_r and columns >= live_c become zeros.
// vec: 16-byte cp.async (the caller checked the alignment; live_c is a
// multiple of 8); else element by element. The caller waits.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long rs, int rows, int live_r,
                                          int cols, int live_c, int vec) {
  if (vec) {
    const int cw = cols / 8;
    for (int e = threadIdx.x; e < rows * cw; e += TC_THREADS) {
      const int r = e / cw, c = (e % cw) * 8;
      const bool ok = r < live_r && c < live_c;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += TC_THREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] = r < live_r && c < live_c ? src[r * rs + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// rows x cols of an fp32 tile (cols a multiple of 4, live_c too) into
// shared memory by 16-byte cp.async; the rest zeros. The caller waits.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src, long long rs,
                                              int rows, int live_r, int cols,
                                              int live_c) {
  const int cw = cols / 4;
  for (int e = threadIdx.x; e < rows * cw; e += TC_THREADS) {
    const int r = e / cw, c = (e % cw) * 4;
    const bool ok = r < live_r && c < live_c;
    cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
  }
}

// dt of head h for the chunk's rows [0, len), zeros past them: loads all
// in flight at once.
__device__ __forceinline__ void load_dt(const TcArgs& p, int bb, int h,
                                        int len, float* dts) {
#pragma unroll
  for (int k = 0; k < QMAX / TC_THREADS; ++k) {
    const int j = threadIdx.x + k * TC_THREADS;
    dts[j] = j < len ? p.dt[bb * p.dsb + (long long)(p.t0 + j) * p.dst +
                            (long long)h * p.dsh]
                     : 0.f;
  }
}

// seg[j] = sum_{i <= j} dt_i a for j < len, by one warp: each lane sums 8
// consecutive products in order, then the lanes' totals are scanned by
// shuffles. No FMA contraction: exp(seg_i - seg_j) turns any error in
// seg into a relative error of the result.
__device__ __forceinline__ void warp_seg(const float* dts, float* seg,
                                         int len, float a, int lane) {
  float v[8], s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = lane * 8 + e;
    s = __fadd_rn(s, j < len ? __fmul_rn(dts[j], a) : 0.f);
    v[e] = s;
  }
  float inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc = __fadd_rn(inc, n);
  }
  float ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = lane * 8 + e;
    if (j < len) seg[j] = __fadd_rn(ex, v[e]);
  }
}

// Output block: rows [i0, i0 + 64) of the chunk for a pair of heads of one
// group. Every load it needs first (C, both carried states, dt) is in
// flight at once; the key tiles stream through two stages.
template <int P>
__device__ void ssd_out_block(const TcArgs& p, int it, int hs, int bb,
                              unsigned char* sm) {
  using Sh = TcShape<P>;
  constexpr int PP = Sh::PP, NT = Sh::NT, LDP = Sh::LDP, LDS = Sh::LDS;
  const int N = p.N, NP = round16(N), LDN = NP + 8, NKS = NP / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  float* segs = reinterpret_cast<float*>(sm);        // [2][QMAX]
  float* dts = segs + 2 * QMAX;                      // [2][QMAX]
  float* cfs = dts + 2 * QMAX;                       // [2][QMAX] column factors
  bf16* Cs = reinterpret_cast<bf16*>(cfs + 2 * QMAX);  // [RT][LDN]
  unsigned char* region = reinterpret_cast<unsigned char*>(Cs + RT * LDN);
  float* Ss = reinterpret_cast<float*>(region);      // [2][NP][LDS]
  const int stage_bytes = out_stage_bytes<P>(N);
  // stage st: B key tile [RT][LDN], then x of both heads [2][RT][LDP]
  auto Bs = [&](int st) {
    return reinterpret_cast<bf16*>(region + st * stage_bytes);
  };
  auto Xs = [&](int st, int hh) { return Bs(st) + RT * LDN + hh * RT * LDP; };

  const int hpg = p.H / p.G, sets = (hpg + 1) / 2;
  const int grp = hs / sets, h0 = grp * hpg + (hs % sets) * 2;
  const int nh = min(2, grp * hpg + hpg - h0);
  const int i0 = it * RT, ni = min(RT, p.q - i0), jend = i0 + ni;
  const bf16* xb = p.x + bb * p.xsb + (long long)p.t0 * p.xst;
  const bf16* bp = p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg;
  const bf16* cp = p.c + bb * p.csb + (long long)p.t0 * p.cst + grp * p.csg;
  const int r_lo = warp * 16;                        // the warp's first row
  const bool live = r_lo < ni;
  const int ia = i0 + r_lo + g, ib = ia + 8;         // its fragment rows

  load_tile(Cs, LDN, cp + (long long)i0 * p.cst, p.cst, RT, ni, NP, N, p.vec);
  if (p.s_in)
    for (int hh = 0; hh < nh; ++hh)
      load_tile_f32(Ss + hh * NP * LDS, LDS,
                    p.s_in + ((long long)bb * p.H + h0 + hh) * N * P, P, NP,
                    N, PP, P);
  cp_async_commit();
  for (int hh = 0; hh < 2; ++hh)
    load_dt(p, bb, h0 + min(hh, nh - 1), hh < nh ? jend : 0, dts + hh * QMAX);
  __syncthreads();
  if (warp < nh)
    warp_seg(dts + warp * QMAX, segs + warp * QMAX, jend,
             -expf(p.a_log[h0 + warp]), lane);
  __syncthreads();
  // Below the diagonal tile the decay factors: exp(seg_i - seg_j) =
  // exp(seg_i - seg_e) exp(seg_e - seg_j), e the last key of j's tile,
  // both exponents <= 0 (no overflow; where one underflows the product is
  // below fp32's range too). The column half, times dt_j, once per block.
  for (int e = tid; e < 2 * QMAX; e += TC_THREADS) {
    const int hh = e / QMAX, j = e % QMAX;
    if (hh < nh && j < i0)
      cfs[e] = expf(segs[hh * QMAX + (j / RT) * RT + RT - 1] -
                    segs[hh * QMAX + j]) * dts[e];
  }
  cp_async_wait<0>();
  __syncthreads();                         // C, states, seg and factors in

  float acc[2][NT][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[hh][n][0] = acc[hh][n][1] = acc[hh][n][2] = acc[hh][n][3] = 0.f;

  // Carried term exp(seg_i) C_i @ S per head, S split into two bf16 terms.
  if (p.s_in && live) {
#pragma unroll 1
    for (int kk = 0; kk < NKS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Cs + (r_lo + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh >= nh) break;
        const float* sb = Ss + hh * NP * LDS + (kk * 16 + 2 * qd) * LDS + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* s = sb + n * 8;
          uint32_t h0b, l0b, h1b, l1b;
          split2(s[0], s[LDS], h0b, l0b);
          split2(s[8 * LDS], s[9 * LDS], h1b, l1b);
          mma_bf16(acc[hh][n], a, h0b, h1b);
          mma_bf16(acc[hh][n], a, l0b, l1b);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float fa = hh < nh && ia < jend ? expf(segs[hh * QMAX + ia]) : 0.f;
      const float fb = hh < nh && ib < jend ? expf(segs[hh * QMAX + ib]) : 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[hh][n][0] *= fa; acc[hh][n][1] *= fa;
        acc[hh][n][2] *= fb; acc[hh][n][3] *= fb;
      }
    }
  }
  __syncthreads();                         // the states' bytes are free

  // Intra-chunk term over the key tiles at or before this row tile, each
  // tile's loads issued while the one before it is computed.
  auto load_keys = [&](int jt) {
    const int j0 = jt * RT, nj = min(RT, p.q - j0), st = jt & 1;
    load_tile(Bs(st), LDN, bp + (long long)j0 * p.bst, p.bst, RT, nj, NP, N,
              p.vec);
    for (int hh = 0; hh < nh; ++hh)
      load_tile(Xs(st, hh), LDP,
                xb + (long long)j0 * p.xst + (long long)(h0 + hh) * p.xsh,
                p.xst, RT, nj, PP, P, p.vec);
    cp_async_commit();
  };
  load_keys(0);
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      load_keys(jt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // tile jt is in
    const int j0 = jt * RT, st = jt & 1;
    if (live) {
      // The tile's scores C_i B_j^T, once for both heads; then 16 keys at a
      // time, per head, the weights split in two bf16 terms, times x. On
      // the diagonal, keys past the warp's last row are dead.
      const int jn_end = jt == it ? 2 * (warp + 1) : RT / 8;
      const bf16* bs = Bs(st);
      float sc[RT / 8][4];
#pragma unroll
      for (int jn = 0; jn < RT / 8; ++jn)
        sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < NKS; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Cs + (r_lo + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jn = 0; jn < RT / 8; jn += 2) {
          if (jn >= jn_end) break;
          uint32_t r[4];
          ldsm_x4(r, bs + (jn * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                         kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[jn], a, r[0], r[1]);
          mma_bf16(sc[jn + 1], a, r[2], r[3]);
        }
      }
      float rf[2][2];                      // exp(seg_i - seg_e), rows ia, ib
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* sg = segs + hh * QMAX;
        const float last = sg[j0 + RT - 1];
        rf[hh][0] = jt < it && hh < nh && ia < jend ? expf(sg[ia] - last) : 0.f;
        rf[hh][1] = jt < it && hh < nh && ib < jend ? expf(sg[ib] - last) : 0.f;
      }
#pragma unroll
      for (int kb = 0; kb < RT / 16; ++kb) {
        if (2 * kb >= jn_end) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (hh >= nh) break;
          const float* sg = segs + hh * QMAX;
          float w[2][4];
          if (jt < it) {                   // every pair live: factors
            const float* cf = cfs + hh * QMAX + j0 + kb * 16 + 2 * qd;
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                w[u][e] = sc[2 * kb + u][e] * rf[hh][e >> 1] *
                          cf[u * 8 + (e & 1)];
          } else {                         // the diagonal: masked, then exp
            const float* dd = dts + hh * QMAX;
            const float sa = ia < jend ? sg[ia] : 0.f;
            const float sb = ib < jend ? sg[ib] : 0.f;
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? ia : ib;
                const int j = j0 + kb * 16 + u * 8 + 2 * qd + (e & 1);
                w[u][e] = j <= i && i < jend
                              ? sc[2 * kb + u][e] *
                                    expf((e < 2 ? sa : sb) - sg[j]) * dd[j]
                              : 0.f;
              }
          }
          uint32_t wh[4], wl[4];
          split2(w[0][0], w[0][1], wh[0], wl[0]);
          split2(w[0][2], w[0][3], wh[1], wl[1]);
          split2(w[1][0], w[1][1], wh[2], wl[2]);
          split2(w[1][2], w[1][3], wh[3], wl[3]);
          const bf16* xs = Xs(st, hh);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t r[4];
            ldsm_x4_t(r, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDP + n * 8 + (lane >> 4) * 8);
            mma_bf16(acc[hh][n], wh, r[0], r[1]);
            mma_bf16(acc[hh][n], wl, r[0], r[1]);
            mma_bf16(acc[hh][n + 1], wh, r[2], r[3]);
            mma_bf16(acc[hh][n + 1], wl, r[2], r[3]);
          }
        }
      }
    }
    if (jt < it) __syncthreads();          // stage st is free for jt + 2
  }

  // y = acc + d_skip x; the last key tile is this row tile, so its stage
  // holds x.
  if (!live) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh >= nh) break;
    const float dsk = p.d_skip[h0 + hh];
    const bf16* xs = Xs(it & 1, hh);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * qd;
      if (col >= P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_lo + g + 8 * half;
        if (r >= ni) continue;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * LDP + col));
        const long long t = p.t0 + i0 + r;
        *reinterpret_cast<__nv_bfloat162*>(
            p.y + ((bb * (long long)p.T + t) * p.H + h0 + hh) * P + col) =
            __floats2bfloat162_rn(acc[hh][n][2 * half] + dsk * xv.x,
                                  acc[hh][n][2 * half + 1] + dsk * xv.y);
      }
    }
  }
}

// State block: rows [n0, n0 + 64) of N of one head's state after the chunk.
template <int P>
__device__ void ssd_state_block(const TcArgs& p, int ns, int h, int bb,
                                unsigned char* sm) {
  using Sh = TcShape<P>;
  constexpr int PP = Sh::PP, NT = Sh::NT, LDP = Sh::LDP;
  const int N = p.N, NP = round16(N), q = p.q, QP = round16(q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  float* dts = reinterpret_cast<float*>(sm);         // [QMAX] dt, then seg
  float* wj = dts + QMAX;                            // [QMAX] decay * dt
  float* seg_last = wj + QMAX;                       // [4]
  bf16* Bt = reinterpret_cast<bf16*>(seg_last + 4);  // [QMAX][LDB]
  bf16* Xt = Bt + QMAX * LDB;                        // [QMAX][LDP]
  float* red = reinterpret_cast<float*>(Xt + QMAX * LDP);  // [4][16][PP]

  const int grp = h / (p.H / p.G), n0 = ns * NSL;
  const int mt_n = min(NSL, NP - n0) / 16;           // 16-row tiles: 1..4
  const int wk = mt_n == 1 ? 4 : mt_n == 2 ? 2 : 1;  // warps per row tile
  load_tile(Bt, LDB,
            p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg + n0,
            p.bst, QP, q, NSL, N - n0, p.vec);
  load_tile(Xt, LDP,
            p.x + bb * p.xsb + (long long)p.t0 * p.xst + (long long)h * p.xsh,
            p.xst, QP, q, PP, P, p.vec);
  cp_async_commit();
  load_dt(p, bb, h, q, dts);
  __syncthreads();
  if (warp == 0) {
    float dtv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) dtv[e] = dts[lane * 8 + e];
    __syncwarp();
    warp_seg(dts, dts, q, -expf(p.a_log[h]), lane);  // in place: lane-local
    __syncwarp();
    const float last = dts[q - 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = lane * 8 + e;
      wj[j] = j < q ? expf(last - dts[j]) * dtv[e] : 0.f;
    }
    if (lane == 0) seg_last[0] = last;
  }

  const int mt = warp % mt_n, kp = warp / mt_n;
  const bool active = warp < mt_n * wk;
  // The carried-in state this warp decays, fetched while the tiles land.
  const long long base = ((long long)bb * p.H + h) * N * P;
  float2 s_old[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n0 + mt * 16 + g + 8 * half, col = n * 8 + 2 * qd;
      s_old[n][half] =
          p.s_in && active && kp == 0 && row < N && col < P
              ? *reinterpret_cast<const float2*>(p.s_in + base +
                                                 (long long)row * P + col)
              : make_float2(0.f, 0.f);
    }
  cp_async_wait<0>();
  __syncthreads();
  const int ks0 = kp * (QP / 16) / wk, ks1 = (kp + 1) * (QP / 16) / wk;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (active) {
    for (int kk = ks0; kk < ks1; ++kk) {
      // A = (B * w)^T: the B slice read transposed, scaled by w_j (its k
      // index), split into three bf16 terms.
      uint32_t r[4];
      ldsm_x4_t(r, Bt + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDB +
                       mt * 16 + ((lane >> 3) & 1) * 8);
      const float* w = wj + kk * 16 + 2 * qd;
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&r[e]));
        const int k = e >= 2 ? 8 : 0;
        split3(f.x * w[k], f.y * w[k + 1], ah[e], am[e], al[e]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, Xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                         n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], ah, b[0], b[1]);
        mma_bf16(acc[n], am, b[0], b[1]);
        mma_bf16(acc[n], al, b[0], b[1]);
        mma_bf16(acc[n + 1], ah, b[2], b[3]);
        mma_bf16(acc[n + 1], am, b[2], b[3]);
        mma_bf16(acc[n + 1], al, b[2], b[3]);
      }
    }
  }
  if (wk > 1) {                            // the row split's partials
    if (active && kp > 0) {
      float* mine = red + warp * 16 * PP;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * qd;
        mine[g * PP + col] = acc[n][0];
        mine[g * PP + col + 1] = acc[n][1];
        mine[(g + 8) * PP + col] = acc[n][2];
        mine[(g + 8) * PP + col + 1] = acc[n][3];
      }
    }
    __syncthreads();
    if (active && kp == 0) {
      for (int k2 = 1; k2 < wk; ++k2) {
        const float* o = red + (mt + k2 * mt_n) * 16 * PP;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * qd;
          acc[n][0] += o[g * PP + col];
          acc[n][1] += o[g * PP + col + 1];
          acc[n][2] += o[(g + 8) * PP + col];
          acc[n][3] += o[(g + 8) * PP + col + 1];
        }
      }
    }
  }
  if (!active || kp != 0) return;
  const float dec = expf(seg_last[0]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * qd;
    if (col >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n0 + mt * 16 + g + 8 * half;
      if (row >= N) continue;
      *reinterpret_cast<float2*>(p.s_out + base + (long long)row * P + col) =
          make_float2(s_old[n][half].x * dec + acc[n][2 * half],
                      s_old[n][half].y * dec + acc[n][2 * half + 1]);
    }
  }
}

// Output blocks first, longest row tile first, then the state blocks.
template <int P>
__global__ void __launch_bounds__(TC_THREADS) ssd_tc_kernel(TcArgs p) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const int bx = blockIdx.x, bb = blockIdx.y;
  if (bx < p.n_yblk) {
    ssd_out_block<P>(p, p.n_rt - 1 - bx / p.n_hs, bx % p.n_hs, bb, tsm);
  } else {
    const int s = bx - p.n_yblk;
    ssd_state_block<P>(p, s % p.n_ns, s / p.n_ns, bb, tsm);
  }
}

// One launch per chunk; the state between chunks goes through scratch,
// two (B, H, N, P) buffers used in turn.
template <int P>
cudaError_t launch_tc(TcArgs a, int batch, int chunk, const float* init,
                      float* fin, float* scratch, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem_bytes<P>(NMAX));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int smem = tc_smem_bytes<P>(a.N);
  const long long state = (long long)batch * a.H * a.N * P;
  const int hpg = a.H / a.G;
  a.n_hs = a.G * ((hpg + 1) / 2);
  a.n_ns = (round16(a.N) + NSL - 1) / NSL;
  a.s_in = init;
  for (int c = 0, t0 = 0; t0 < a.T; ++c, t0 += chunk) {
    a.t0 = t0;
    a.q = min(chunk, a.T - t0);
    const bool last = t0 + a.q >= a.T;
    if (!last && !scratch) return cudaErrorInvalidValue;
    a.s_out = last ? fin : scratch + (c % 2) * state;
    a.n_rt = (a.q + RT - 1) / RT;
    a.n_yblk = a.n_rt * a.n_hs;
    const int blocks = a.n_yblk + (a.s_out ? a.n_ns * a.H : 0);
    ssd_tc_kernel<P><<<dim3(blocks, batch), TC_THREADS, smem, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a.s_in = a.s_out;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int ssd_launch(
    const void* x, long long xsb, long long xst, long long xsh,
    const float* dt, long long dsb, long long dst, long long dsh,
    const float* a_log, const float* d_skip,
    const void* b, long long bsb, long long bst, long long bsg,
    const void* c, long long csb, long long cst, long long csg,
    const float* init, void* y, float* fin, float* scratch, int B, int T,
    int H, int G, int N, int P, int chunk, int dtype, int vec, void* stream) {
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
  if (dtype != DT_BF16) return (int)by_dim(P, a, B, s);
  TcArgs t{};
  t.x = static_cast<const bf16*>(x); t.xsb = xsb; t.xst = xst; t.xsh = xsh;
  t.dt = dt; t.dsb = dsb; t.dst = dst; t.dsh = dsh;
  t.a_log = a_log; t.d_skip = d_skip;
  t.b = static_cast<const bf16*>(b); t.bsb = bsb; t.bst = bst; t.bsg = bsg;
  t.c = static_cast<const bf16*>(c); t.csb = csb; t.cst = cst; t.csg = csg;
  t.y = static_cast<bf16*>(y);
  t.T = T; t.H = H; t.G = G; t.N = N;
  t.vec = vec;
  switch (P) {
    case 8: return (int)launch_tc<8>(t, B, chunk, init, fin, scratch, s);
    case 16: return (int)launch_tc<16>(t, B, chunk, init, fin, scratch, s);
    case 32: return (int)launch_tc<32>(t, B, chunk, init, fin, scratch, s);
    case 64: return (int)launch_tc<64>(t, B, chunk, init, fin, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
