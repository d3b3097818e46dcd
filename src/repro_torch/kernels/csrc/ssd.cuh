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
// fp16 inputs (an fp16 model) run ssd_tc_kernel with T = __half, straight
// from the caller's views: the same tiles, copies and shared memory as
// bf16. The scores C_i B_j^T run on the .f16 MMA (fp16 x fp16 products are
// exact in fp32, as bf16's are). Every other product splits its fp16
// operand fragment, after ldmatrix, into two bf16 terms hi + lo that sum to
// it exactly (fp16's 11-bit significand and its whole exponent range fit
// two bf16 terms; split_f16) and runs on the bf16 MMA beside the existing
// splits of the fp32-by-definition operands: C of the carried term against
// S's two terms (3 products: the lo x lo one is below S's own split), x
// against the weights' two terms (3), x against B * w's three terms in the
// state update (5: all but lo x lo). bf16 has fp32's exponent, so the
// weights, the carried state and B * w (which pass 65504 where x is large)
// keep their range: a split into .f16 terms would overflow there. y is
// rounded to fp16 in the store (__float2half_rn, past 65504 +-inf, as XLA
// rounds the JAX kernel's fp32 y); the states stay fp32. The JAX kernel
// upcasts x, B and C to fp32 in its body and rounds y once at the end.
//
// fp32 inputs (the fp32 gate, phases 7-8's fp32 logits) run ssd_kernel on
// the CUDA cores in IEEE fp32 (the tensor cores take no fp32 operands),
// one launch per chunk like the bf16 kernel. Bound by operations there (67
// TFLOP/s): at mamba2-1.3b's widths a fresh 256-token chunk is ~0.54 GFLOP,
// ~8 us, spread over the card as clusters of two 128-thread blocks:
//  * output pairs, one per (32-row tile of the chunk, pair of heads of one
//    B/C group, batch row), longest row tile first. The two blocks split
//    the 32-key tiles at or before the row tile (block r takes tiles r, r
//    + 2, ...), so the last row tile's chain of 8 key tiles is 4 long.
//    Each loads its C tile and dt at once; the block without the diagonal
//    tile also takes the carried term, only where a state came in. The key
//    tiles stream through two cp.async stages. A tile's scores C_i B_j^T
//    are computed once for both heads (4 x 2 per thread, float4 reads along
//    N), weighted per head into a shared tile with the decay factored below
//    the diagonal as for bf16, and multiplied with x (4 rows x 4 channels
//    per thread). The block with the diagonal tile adds the other's sums
//    over distributed shared memory, then d_skip x, and stores y;
//  * state blocks, one per (64-row slice of N, head, batch row; 32 rows
//    where N <= 32), when a state is asked for: S_out = exp(seg_last) S_in
//    + B^T (w * X), the chunk's rows streaming through two stages (8 x 4,
//    or 4 x 4, per thread); they run after the later half of the row
//    tiles.
// seg is a warp's scan (warp_seg). Every sum runs in a fixed order and
// there are no atomics, so a rerun is bit-identical.
//
// Both read x, B, C and dt through their strides (the model's views into
// its fused projection), copying 16-byte rows with cp.async where the views
// allow it, else element by element, and handle ragged chunks with row
// predicates, never a padded copy. Head dims P in {8, 16, 32, 64} are
// compiled; N <= 256 and Q <= 256 are runtime values. dt, a_log, d_skip
// and the states are fp32; y comes out in x's type.
//
// Any other head dim runs as column slices: y[..., p] and column p of the
// state depend on x[..., p] alone (C B^T and the decay are the same for
// every column), so the grid's z axis takes slices of the compiled width
// PC (64 for P > 32, else the next compiled one), slice z owning columns
// [z PC, z PC + PC) of x, y and the states, each recomputing C B^T; the
// last slice zero-fills its columns past P. P is the rows' runtime stride
// (pf) and a state row is copied by 16-byte words only where P is a
// multiple of 4 (svec), else element by element. At N = 256 one block
// holds a 64-row C tile and both heads' carried states (bf16: 175 KB of
// shared memory at P = 64, fp32: 184 KB), under the 227 KB a block may
// have; past N = 320 they no longer fit (ssd_plan refuses N > 256). A
// chunk longer than 256 rows is the wrapper's: it runs as sub-chunks of
// 256, the state carried through the scratch (the same function, the
// fp32 sums grouped by 256 rows).
//
// Four libraries share this code: ssd.cu instantiates the kernels with GEN
// = false for P in {8, 16, 32, 64} and N <= 128 (the registry's models; the
// code these kernels were first written as, the states' row P and no
// slice), ssd_any.cu with GEN = true for every other head dim and N <= 256
// (kernels/mamba2.py picks the library per call); ssd16.cu and
// ssd16_any.cu the fp16 instances of ssd_tc_kernel at GEN = false and true
// (SSD_HALF). They build in parallel.
//
// C interface (both libraries): ssd_launch, returning cudaGetLastError(),
// and ssd_plan, its launch geometry.

#pragma once

#ifndef SSD_GENERIC
#error "define SSD_GENERIC (false: ssd.cu, ssd16.cu; true: the _any units)"
#endif
#ifndef SSD_HALF
#define SSD_HALF false          // true: ssd16.cu, ssd16_any.cu (fp16 only)
#endif

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int QMAX = 256;     // longest chunk
constexpr int NMAX = 256;     // largest state size (ssd_any.cu)
constexpr int NMAX_FIRST = 128;   // ... of ssd.cu's instances
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// ---------------------------------------------------------------------------
// bf16 and fp16: ssd_tc_kernel, one chunk per launch on tensor cores.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TC_THREADS = 128;   // 4 warps
constexpr int RT = 64;            // chunk rows per output block, 16 a warp
constexpr int NSL = 64;           // state rows (of N) per state block
constexpr int LDB = NSL + 8;      // bf16 row of a state block's B slice

// E: the inputs' and y's type, bf16 or __half.
template <typename E>
struct TcArgs {
  const E* x; long long xsb, xst, xsh;       // (B, T, H, P), in elements
  const float* dt; long long dsb, dst, dsh;  // (B, T, H)
  const float* a_log;                        // (H,)
  const float* d_skip;                       // (H,)
  const E* b; long long bsb, bst, bsg;       // (B, T, G, N)
  const E* c; long long csb, cst, csg;
  const float* s_in;                         // (B, H, N, P) or null (zeros)
  float* s_out;                              // (B, H, N, P) or null (none)
  E* y;                                      // (B, T, H, P) contiguous
  int T, H, G, N;
  int t0, q;                                 // this chunk: rows [t0, t0 + q)
  int n_rt, n_hs, n_ns;                      // row tiles, head pairs, N slices
  int n_yblk;                                // output blocks per batch row
  int vec;                                   // 16-byte rows: cp.async
  int pf, svec;                              // P (y / state row); rows16
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
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
// c += a (16x16, row) * b (16x8, col); fp16 in, fp32 accumulate.
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The scores' MMA of the inputs' type: bf16 or fp16 (each exact products).
template <typename T>
__device__ __forceinline__ void mma_in(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t bits(__half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// A pair of 16-bit values of type T (one register) as two floats, and two
// floats rounded to nearest even into such a pair (fp16: past 65504, inf).
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<bf16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}
template <typename T> __device__ __forceinline__ uint32_t pack2(float x,
                                                                float y);
template <> __device__ __forceinline__ uint32_t pack2<bf16>(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float x,
                                                              float y) {
  return bits(__floats2half2_rn(x, y));
}
template <typename T> __device__ __forceinline__ T round1(float x);
template <> __device__ __forceinline__ bf16 round1<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half round1<__half>(float x) {
  return __float2half_rn(x);
}
// (x, y) as a bf16 pair hi plus the pair of what rounding left, lo.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
// A pair of fp16 values as bf16 pairs hi + lo that sum to it exactly: hi
// the nearest bf16, lo the remainder (at most 4 of fp16's ulps, a bf16 in
// fp32's exponent range; an fp16 infinity leaves a NaN remainder).
__device__ __forceinline__ void split_f16(uint32_t v, uint32_t& hi,
                                          uint32_t& lo) {
  const float2 f = unpack2<__half>(v);
  split2(f.x, f.y, hi, lo);
}
// The four registers of an fp16 MMA fragment, each split so.
__device__ __forceinline__ void split_frag(const uint32_t (&v)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_f16(v[e], hi[e], lo[e]);
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

// rows x cols of a 16-bit tile (bf16 or fp16) into shared memory (row
// stride ld) from rows rs elements apart; rows >= live_r and columns >=
// live_c become zeros. vec: 16-byte cp.async (the caller checked the
// alignment; live_c is a multiple of 8); else element by element. The
// caller waits.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
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
                                                 : round1<T>(0.f);
    }
  }
}

// rows x cols of an fp32 tile (cols a multiple of 4) into shared memory;
// the rest zeros. vec: by 16-byte cp.async (rows 16-byte aligned, live_c a
// multiple of 4); else element by element. The caller waits.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src, long long rs,
                                              int rows, int live_r, int cols,
                                              int live_c, int vec) {
  if (!vec) {
    for (int e = threadIdx.x; e < rows * cols; e += TC_THREADS) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] = r < live_r && c < live_c ? src[r * rs + c] : 0.f;
    }
    return;
  }
  const int cw = cols / 4;
  for (int e = threadIdx.x; e < rows * cw; e += TC_THREADS) {
    const int r = e / cw, c = (e % cw) * 4;
    const bool ok = r < live_r && c < live_c;
    cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
  }
}

// n <= 2 (or 4) live fp32 elements of a state or y row at p, zeros past
// them: one 8- (16-) byte access where the rows are whole 16-byte words
// (vec: then n is 0 or at least the width), else element by element.
__device__ __forceinline__ float2 ld_f2(const float* p, int n, int vec) {
  if (vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f);
}
__device__ __forceinline__ void st_f2(float* p, float2 v, int n, int vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
}
__device__ __forceinline__ float4 ld_f4(const float* p, int n, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ void st_f4(float* p, float4 v, int n, int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

// dt of head h for the chunk's rows [0, len), zeros past them: loads all
// in flight at once.
template <typename Args>
__device__ __forceinline__ void load_dt(const Args& p, int bb, int h,
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
template <int P, bool GEN, typename T>
__device__ void ssd_out_block(const TcArgs<T>& p, int it, int hs, int bb,
                              unsigned char* sm) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  using Sh = TcShape<P>;
  constexpr int PP = Sh::PP, NT = Sh::NT, LDP = Sh::LDP, LDS = Sh::LDS;
  const int N = p.N, NP = round16(N), LDN = NP + 8, NKS = NP / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  float* segs = reinterpret_cast<float*>(sm);        // [2][QMAX]
  float* dts = segs + 2 * QMAX;                      // [2][QMAX]
  float* cfs = dts + 2 * QMAX;                       // [2][QMAX] column factors
  T* Cs = reinterpret_cast<T*>(cfs + 2 * QMAX);      // [RT][LDN]
  unsigned char* region = reinterpret_cast<unsigned char*>(Cs + RT * LDN);
  float* Ss = reinterpret_cast<float*>(region);      // [2][NP][LDS]
  const int stage_bytes = out_stage_bytes<P>(N);
  // stage st: B key tile [RT][LDN], then x of both heads [2][RT][LDP]
  auto Bs = [&](int st) {
    return reinterpret_cast<T*>(region + st * stage_bytes);
  };
  auto Xs = [&](int st, int hh) { return Bs(st) + RT * LDN + hh * RT * LDP; };

  const int hpg = p.H / p.G, sets = (hpg + 1) / 2;
  const int grp = hs / sets, h0 = grp * hpg + (hs % sets) * 2;
  const int nh = min(2, grp * hpg + hpg - h0);
  const int i0 = it * RT, ni = min(RT, p.q - i0), jend = i0 + ni;
  // this block's column slice: [p0, p0 + pw) of x, y and the states,
  // rows of pf (!GEN: the one slice, P wide, rows of P)
  const int p0 = GEN ? blockIdx.z * P : 0, pw = GEN ? min(P, p.pf - p0) : P;
  const int pf = GEN ? p.pf : P, svec = GEN ? p.svec : 1;
  const T* xb = p.x + bb * p.xsb + (long long)p.t0 * p.xst + p0;
  const T* bp = p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg;
  const T* cp = p.c + bb * p.csb + (long long)p.t0 * p.cst + grp * p.csg;
  const int r_lo = warp * 16;                        // the warp's first row
  const bool live = r_lo < ni;
  const int ia = i0 + r_lo + g, ib = ia + 8;         // its fragment rows

  load_tile(Cs, LDN, cp + (long long)i0 * p.cst, p.cst, RT, ni, NP, N, p.vec);
  if (p.s_in)
    for (int hh = 0; hh < nh; ++hh)
      load_tile_f32(Ss + hh * NP * LDS, LDS,
                    p.s_in + ((long long)bb * p.H + h0 + hh) * N * pf + p0,
                    pf, NP, N, PP, pw, svec);
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

  // Carried term exp(seg_i) C_i @ S per head, S split into two bf16 terms
  // (fp16: C too, exactly).
  if (p.s_in && live) {
#pragma unroll 1
    for (int kk = 0; kk < NKS; ++kk) {
      uint32_t a[4], ah[4], al[4];
      ldsm_x4(a, Cs + (r_lo + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
      if constexpr (F16) split_frag(a, ah, al);
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
          if constexpr (F16) {
            mma_bf16(acc[hh][n], ah, h0b, h1b);
            mma_bf16(acc[hh][n], ah, l0b, l1b);
            mma_bf16(acc[hh][n], al, h0b, h1b);
          } else {
            mma_bf16(acc[hh][n], a, h0b, h1b);
            mma_bf16(acc[hh][n], a, l0b, l1b);
          }
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
                p.xst, RT, nj, PP, pw, p.vec);
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
      const T* bs = Bs(st);
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
          mma_in<T>(sc[jn], a, r[0], r[1]);
          mma_in<T>(sc[jn + 1], a, r[2], r[3]);
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
      // 16 keys at a time: their scores (a register select, so that a
      // loop that is not unrolled keeps sc in registers), per head the
      // weights and the products with x.
      auto key_block = [&](const int kb) {
        float skb[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            skb[u][e] = kb == 0 ? sc[u][e] : kb == 1 ? sc[2 + u][e]
                        : kb == 2 ? sc[4 + u][e] : sc[6 + u][e];
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
                w[u][e] = skb[u][e] * rf[hh][e >> 1] *
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
                              ? skb[u][e] *
                                    expf((e < 2 ? sa : sb) - sg[j]) * dd[j]
                              : 0.f;
              }
          }
          uint32_t wh[4], wl[4];
          split2(w[0][0], w[0][1], wh[0], wl[0]);
          split2(w[0][2], w[0][3], wh[1], wl[1]);
          split2(w[1][0], w[1][1], wh[2], wl[2]);
          split2(w[1][2], w[1][3], wh[3], wl[3]);
          const T* xs = Xs(st, hh);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t r[4];
            ldsm_x4_t(r, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDP + n * 8 + (lane >> 4) * 8);
            if constexpr (F16) {             // x = hi + lo, exactly
              uint32_t rh[4], rl[4];
              split_frag(r, rh, rl);
              mma_bf16(acc[hh][n], wh, rh[0], rh[1]);
              mma_bf16(acc[hh][n], wh, rl[0], rl[1]);
              mma_bf16(acc[hh][n], wl, rh[0], rh[1]);
              mma_bf16(acc[hh][n + 1], wh, rh[2], rh[3]);
              mma_bf16(acc[hh][n + 1], wh, rl[2], rl[3]);
              mma_bf16(acc[hh][n + 1], wl, rh[2], rh[3]);
            } else {
              mma_bf16(acc[hh][n], wh, r[0], r[1]);
              mma_bf16(acc[hh][n], wl, r[0], r[1]);
              mma_bf16(acc[hh][n + 1], wh, r[2], r[3]);
              mma_bf16(acc[hh][n + 1], wl, r[2], r[3]);
            }
          }
        }
      };
      static_assert(RT / 16 == 4, "key_block selects one of 4 key blocks");
      if constexpr (F16) {
        // fp16's block is twice bf16's code (the x splits, a third MMA).
        // Unrolled, a block's first key tile took twice its next one
        // (instruction fetch, tools/ssd_phases.py --fp16) and the call a
        // quarter longer; looped, the code stays in the cache.
#pragma unroll 1
        for (int kb = 0; kb < RT / 16; ++kb) {
          if (2 * kb >= jn_end) break;
          key_block(kb);
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < RT / 16; ++kb) {
          if (2 * kb >= jn_end) break;
          key_block(kb);
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
    const T* xs = Xs(it & 1, hh);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * qd;
      if (col >= pw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_lo + g + 8 * half;
        if (r >= ni) continue;
        const float2 xv = unpack2<T>(
            *reinterpret_cast<const uint32_t*>(xs + r * LDP + col));
        const long long t = p.t0 + i0 + r;
        T* yp = p.y + ((bb * (long long)p.T + t) * p.H + h0 + hh) * pf + p0 +
                col;
        const float y0 = acc[hh][n][2 * half] + dsk * xv.x;
        const float y1 = acc[hh][n][2 * half + 1] + dsk * xv.y;
        if (!GEN || (col + 1 < pw && !(pf & 1))) {   // an aligned pair
          *reinterpret_cast<uint32_t*>(yp) = pack2<T>(y0, y1);
        } else {
          yp[0] = round1<T>(y0);
          if (col + 1 < pw) yp[1] = round1<T>(y1);
        }
      }
    }
  }
}

// State block: rows [n0, n0 + 64) of N of one head's state after the chunk.
template <int P, bool GEN, typename T>
__device__ void ssd_state_block(const TcArgs<T>& p, int ns, int h, int bb,
                                unsigned char* sm) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  using Sh = TcShape<P>;
  constexpr int PP = Sh::PP, NT = Sh::NT, LDP = Sh::LDP;
  const int N = p.N, NP = round16(N), q = p.q, QP = round16(q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  float* dts = reinterpret_cast<float*>(sm);         // [QMAX] dt, then seg
  float* wj = dts + QMAX;                            // [QMAX] decay * dt
  float* seg_last = wj + QMAX;                       // [4]
  T* Bt = reinterpret_cast<T*>(seg_last + 4);        // [QMAX][LDB]
  T* Xt = Bt + QMAX * LDB;                           // [QMAX][LDP]
  float* red = reinterpret_cast<float*>(Xt + QMAX * LDP);  // [4][16][PP]

  const int grp = h / (p.H / p.G), n0 = ns * NSL;
  const int mt_n = min(NSL, NP - n0) / 16;           // 16-row tiles: 1..4
  const int wk = mt_n == 1 ? 4 : mt_n == 2 ? 2 : 1;  // warps per row tile
  load_tile(Bt, LDB,
            p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg + n0,
            p.bst, QP, q, NSL, N - n0, p.vec);
  const int p0 = GEN ? blockIdx.z * P : 0, pw = GEN ? min(P, p.pf - p0) : P;
  const int pf = GEN ? p.pf : P, svec = GEN ? p.svec : 1;
  load_tile(Xt, LDP,
            p.x + bb * p.xsb + (long long)p.t0 * p.xst + (long long)h * p.xsh +
                p0,
            p.xst, QP, q, PP, pw, p.vec);
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
  const long long base = ((long long)bb * p.H + h) * N * pf + p0;
  float2 s_old[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n0 + mt * 16 + g + 8 * half, col = n * 8 + 2 * qd;
      s_old[n][half] =
          p.s_in && active && kp == 0 && row < N && col < pw
              ? ld_f2(p.s_in + base + (long long)row * pf + col, pw - col,
                      svec)
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
      // index), split into three bf16 terms (fp16: x into two, exactly).
      uint32_t r[4];
      ldsm_x4_t(r, Bt + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDB +
                       mt * 16 + ((lane >> 3) & 1) * 8);
      const float* w = wj + kk * 16 + 2 * qd;
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack2<T>(r[e]);
        const int k = e >= 2 ? 8 : 0;
        split3(f.x * w[k], f.y * w[k + 1], ah[e], am[e], al[e]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, Xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                         n * 8 + (lane >> 4) * 8);
        if constexpr (F16) {                 // every term but lo x lo
          uint32_t bh[4], bl[4];
          split_frag(b, bh, bl);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            mma_bf16(acc[n + v], ah, bh[2 * v], bh[2 * v + 1]);
            mma_bf16(acc[n + v], ah, bl[2 * v], bl[2 * v + 1]);
            mma_bf16(acc[n + v], am, bh[2 * v], bh[2 * v + 1]);
            mma_bf16(acc[n + v], am, bl[2 * v], bl[2 * v + 1]);
            mma_bf16(acc[n + v], al, bh[2 * v], bh[2 * v + 1]);
          }
        } else {
          mma_bf16(acc[n], ah, b[0], b[1]);
          mma_bf16(acc[n], am, b[0], b[1]);
          mma_bf16(acc[n], al, b[0], b[1]);
          mma_bf16(acc[n + 1], ah, b[2], b[3]);
          mma_bf16(acc[n + 1], am, b[2], b[3]);
          mma_bf16(acc[n + 1], al, b[2], b[3]);
        }
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
    if (col >= pw) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n0 + mt * 16 + g + 8 * half;
      if (row >= N) continue;
      st_f2(p.s_out + base + (long long)row * pf + col,
            make_float2(s_old[n][half].x * dec + acc[n][2 * half],
                        s_old[n][half].y * dec + acc[n][2 * half + 1]),
            pw - col, svec);
    }
  }
}

// Output blocks first, longest row tile first, then the state blocks.
template <int P, bool GEN, typename T>
__global__ void __launch_bounds__(TC_THREADS) ssd_tc_kernel(TcArgs<T> p) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const int bx = blockIdx.x, bb = blockIdx.y;
  if (bx < p.n_yblk) {
    ssd_out_block<P, GEN, T>(p, p.n_rt - 1 - bx / p.n_hs, bx % p.n_hs, bb,
                             tsm);
  } else {
    const int s = bx - p.n_yblk;
    ssd_state_block<P, GEN, T>(p, s % p.n_ns, s / p.n_ns, bb, tsm);
  }
}

// One chunk's launch geometry (chunk_geom, with the fp32 kernel's below).
struct ChunkGeom {
  int q, n_rt, n_hs, n_ns, n_yblk, n_state, blocks;
};
inline ChunkGeom chunk_geom(int dtype, int T, int H, int G, int N, int chunk,
                            int t0, bool has_out);

// One launch per chunk, the column slices on the grid's z; the state
// between chunks goes through scratch, two (B, H, N, P) buffers used in
// turn.
template <int P, bool GEN, typename T>
cudaError_t launch_tc(TcArgs<T> a, int batch, int slices, int chunk,
                      const float* init, float* fin, float* scratch,
                      cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<P, GEN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem_bytes<P>(GEN ? NMAX : NMAX_FIRST));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int smem = tc_smem_bytes<P>(a.N);
  const long long state = (long long)batch * a.H * a.N * a.pf;
  a.s_in = init;
  for (int c = 0, t0 = 0; t0 < a.T; ++c, t0 += chunk) {
    const bool last = t0 + min(chunk, a.T - t0) >= a.T;
    if (!last && !scratch) return cudaErrorInvalidValue;
    a.s_out = last ? fin : scratch + (c % 2) * state;
    const ChunkGeom g = chunk_geom(DT_BF16, a.T, a.H, a.G, a.N, chunk, t0,
                                   a.s_out != nullptr);
    a.t0 = t0;
    a.q = g.q;
    a.n_hs = g.n_hs;
    a.n_ns = g.n_ns;
    a.n_rt = g.n_rt;
    a.n_yblk = g.n_yblk;
    const int blocks = g.blocks;
    ssd_tc_kernel<P, GEN, T><<<dim3(blocks, batch, slices), TC_THREADS, smem,
                               s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a.s_in = a.s_out;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// fp32: ssd_kernel, one chunk per launch on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int F_THREADS = TC_THREADS;   // 4 warps (the loaders' stride)
constexpr int FRT = 32;       // chunk rows per output block
constexpr int FKT = 32;       // keys per key tile (== FRT: the last key tile
                              // of an output block is its own row tile)
// state rows (of N) per state block: 64 where N > 32, else 32
__host__ __device__ constexpr int f32_state_rows(int n) {
  return n > 32 ? 64 : 32;
}

// One chunk's launch geometry, bf16 or fp16 (tensor cores) or fp32 (CUDA
// cores):
// its rows q, row tiles, head pairs, state slices of N, output and state
// blocks, and the grid's blocks (fp32: output blocks in clusters of two,
// the state blocks made even). has_out: the chunk writes a state (every
// chunk but the last, and the last where the caller wants the final one).
inline ChunkGeom chunk_geom(int dtype, int T, int H, int G, int N, int chunk,
                            int t0, bool has_out) {
  ChunkGeom g;
  g.q = min(chunk, T - t0);
  const int hpg = H / G;
  g.n_hs = G * ((hpg + 1) / 2);
  if (dtype != DT_F32) {
    g.n_ns = (round16(N) + NSL - 1) / NSL;
    g.n_rt = (g.q + RT - 1) / RT;
    g.n_yblk = g.n_rt * g.n_hs;
    g.n_state = has_out ? g.n_ns * H : 0;
    g.blocks = g.n_yblk + g.n_state;
  } else {
    g.n_ns = (N + f32_state_rows(N) - 1) / f32_state_rows(N);
    g.n_rt = (g.q + FRT - 1) / FRT;
    g.n_yblk = 2 * g.n_rt * g.n_hs;
    g.n_state = has_out ? g.n_ns * H : 0;
    g.blocks = g.n_yblk + ((g.n_state + 1) & ~1);
  }
  return g;
}

struct F32Args {
  const float* x; long long xsb, xst, xsh;   // (B, T, H, P), in elements
  const float* dt; long long dsb, dst, dsh;  // (B, T, H)
  const float* a_log;                        // (H,)
  const float* d_skip;                       // (H,)
  const float* b; long long bsb, bst, bsg;   // (B, T, G, N)
  const float* c; long long csb, cst, csg;
  const float* s_in;                         // (B, H, N, P) or null (zeros)
  float* s_out;                              // (B, H, N, P) or null (none)
  float* y;                                  // (B, T, H, P) contiguous
  int T, H, G, N;
  int t0, q;                                 // this chunk: rows [t0, t0 + q)
  int n_rt, n_hs, n_ns;                      // row tiles, head pairs, N slices
  int n_yblk, n_state;                       // output / state blocks per row
  int vec;                                   // 16-byte rows: cp.async
  int pf, svec;                              // P (y / state row); rows16
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Per head dim: the product's threads. Thread t owns TM rows (row group
// t / PT) and 4 consecutive channels (column group t % PT) of a 32-row
// tile; P = 8 leaves half the threads out of it.
template <int P>
struct FShape {
  static constexpr int PT = P / 4;
  static constexpr int RG = F_THREADS / PT < FRT ? F_THREADS / PT : FRT;
  static constexpr int TM = FRT / RG;
  static constexpr int ACTIVE = RG * PT;
  static constexpr int LDP = P + 4;          // floats per x / state row
};

// Shared floats. Output block: seg, dt and column factors of two heads,
// the C tile, both heads' weight tiles, then one region that holds first
// both heads' carried states and then two stages of key tiles (B and both
// heads' x). State block: dt (then seg), the weights, two stages of the B
// slice and x.
template <int P>
__host__ __device__ constexpr int f32_region_floats(int n) {
  return 2 * (FKT * (round4(n) + 4) + 2 * FKT * FShape<P>::LDP) >
                 2 * round4(n) * FShape<P>::LDP
             ? 2 * (FKT * (round4(n) + 4) + 2 * FKT * FShape<P>::LDP)
             : 2 * round4(n) * FShape<P>::LDP;
}
template <int P>
__host__ __device__ constexpr int f32_smem_bytes(int n) {
  const int out = 6 * QMAX + FRT * (round4(n) + 4) + 2 * FRT * (FKT + 4) +
                  f32_region_floats<P>(n);
  const int state = 2 * QMAX + 4 + 2 * (FKT * (64 + 4) + FKT * FShape<P>::LDP);
  return 4 * (out > state ? out : state);
}

// rows x cols of an fp32 tile into shared memory (row stride ld) from rows
// rs elements apart; rows >= live_r and columns >= live_c become zeros.
// vec: 16-byte cp.async (rows 16-byte aligned, cols and live_c multiples
// of 4, cols <= 512); else element by element. A thread keeps one column
// and walks rows (one division per call, not one per chunk). The caller
// waits.
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         long long rs, int rows, int live_r,
                                         int cols, int live_c, int vec) {
  if (vec) {
    const int cw = cols / 4, step = F_THREADS / cw;
    const int r0 = threadIdx.x / cw, c = (threadIdx.x - r0 * cw) * 4;
    if (r0 >= step) return;
    for (int r = r0; r < rows; r += step) {
      const bool ok = r < live_r && c < live_c;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += F_THREADS) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] = r < live_r && c < live_c ? src[r * rs + c] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Output block: rows [i0, i0 + 32) of the chunk for a pair of heads of one
// group, on the CUDA cores; one of a cluster of two that split the key
// tiles at or before the row tile (rank r takes tiles r, r + 2, ...). The
// rank without the diagonal tile also takes the carried term and hands its
// sums to the other over distributed shared memory, which adds them, the
// skip term, and stores. Each rank's first loads (C, the carried states,
// dt) are in flight at once; its key tiles stream through two stages.
template <int P, bool GEN>
__device__ void f32_out_block(const F32Args& p, int it, int hs, int rank,
                              int bb, float* sm) {
  using Sh = FShape<P>;
  constexpr int LDP = Sh::LDP, TM = Sh::TM, PT = Sh::PT, LDW = FKT + 4;
  const int N = p.N, NP = round4(N), LDN = NP + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* segs = sm;                                  // [2][QMAX]
  float* dts = segs + 2 * QMAX;                      // [2][QMAX]
  float* cfs = dts + 2 * QMAX;                       // [2][QMAX] column factors
  float* Cs = cfs + 2 * QMAX;                        // [FRT][LDN]
  float* Ws = Cs + FRT * LDN;                        // [2][FRT][LDW]
  float* region = Ws + 2 * FRT * LDW;
  float* Ss = region;                                // [2][NP][LDP]
  const int stage = FKT * LDN + 2 * FKT * LDP;       // B [FKT][LDN], x [2][FKT][LDP]
  auto Bs = [&](int st) { return region + st * stage; };
  auto Xs = [&](int st, int hh) {
    return region + st * stage + FKT * LDN + hh * FKT * LDP;
  };

  const int hpg = p.H / p.G, sets = (hpg + 1) / 2;
  const int grp = hs / sets, h0 = grp * hpg + (hs % sets) * 2;
  const int nh = min(2, grp * hpg + hpg - h0);
  const int i0 = it * FRT, ni = min(FRT, p.q - i0), jend = i0 + ni;
  const int diag = it & 1;                  // the rank with the diagonal tile
  const bool carries = p.s_in != nullptr && rank != diag;
  const int count = it >= rank ? (it - rank) / 2 + 1 : 0;   // key tiles
  // this block's column slice: [p0, p0 + pw) of x, y and the states,
  // rows of pf (!GEN: the one slice, P wide, rows of P)
  const int p0 = GEN ? blockIdx.z * P : 0, pw = GEN ? min(P, p.pf - p0) : P;
  const int pf = GEN ? p.pf : P, svec = GEN ? p.svec : 1;
  const float* xb = p.x + bb * p.xsb + (long long)p.t0 * p.xst + p0;
  const float* bp = p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg;
  const float* cp = p.c + bb * p.csb + (long long)p.t0 * p.cst + grp * p.csg;

  load_f32(Cs, LDN, cp + (long long)i0 * p.cst, p.cst, FRT, ni, NP, N, p.vec);
  if (carries)
    for (int hh = 0; hh < nh; ++hh)
      load_f32(Ss + hh * NP * LDP, LDP,
               p.s_in + ((long long)bb * p.H + h0 + hh) * N * pf + p0, pf,
               NP, N, P, pw, svec);
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
  // both exponents <= 0. The column half, times dt_j, once per block.
  for (int e = tid; e < 2 * QMAX; e += F_THREADS) {
    const int hh = e / QMAX, j = e % QMAX;
    if (hh < nh && j < i0)
      cfs[e] = expf(segs[hh * QMAX + (j / FKT) * FKT + FKT - 1] -
                    segs[hh * QMAX + j]) * dts[e];
  }
  cp_async_wait<0>();
  __syncthreads();                         // C, states, dt, seg, factors in

  // The product's place: rows r0 .. r0 + TM - 1, channels c0 .. c0 + 3.
  const bool active = tid < Sh::ACTIVE;
  const int r0 = (tid / PT) * TM, c0 = (tid % PT) * 4;
  float acc[2][TM][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int u = 0; u < TM; ++u)
      acc[hh][u][0] = acc[hh][u][1] = acc[hh][u][2] = acc[hh][u][3] = 0.f;

  // Carried term exp(seg_i) C_i @ S per head, only where a state came in.
  if (carries && active) {
#pragma unroll 2
    for (int n = 0; n < NP; n += 4) {
      float4 a[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u) a[u] = ld4(Cs + (r0 + u) * LDN + n);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh >= nh) break;
        const float* sb = Ss + hh * NP * LDP + n * LDP + c0;
        const float4 b[4] = {ld4(sb), ld4(sb + LDP), ld4(sb + 2 * LDP),
                             ld4(sb + 3 * LDP)};
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            float s = acc[hh][u][v];
#pragma unroll
            for (int k = 0; k < 4; ++k) s = fmaf(at(a[u], k), at(b[k], v), s);
            acc[hh][u][v] = s;
          }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int i = i0 + r0 + u;
        const float f = hh < nh && i < jend ? expf(segs[hh * QMAX + i]) : 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[hh][u][v] *= f;
      }
  }
  __syncthreads();                         // the states' floats are free

  // Intra-chunk term over this rank's key tiles, each tile's loads issued
  // while the one before it is computed. The scores C_i B_j^T of a tile
  // once for both heads (thread: rows 4 (tid / 16) .. + 3, keys 2 (tid %
  // 16), + 1), weighted per head into its W tile, then W @ x per head.
  auto load_keys = [&](int jt, int st) {
    const int j0 = jt * FKT, nj = min(FKT, p.q - j0);
    load_f32(Bs(st), LDN, bp + (long long)j0 * p.bst, p.bst, FKT, nj, NP, N,
             p.vec);
    for (int hh = 0; hh < nh; ++hh)
      load_f32(Xs(st, hh), LDP,
               xb + (long long)j0 * p.xst + (long long)(h0 + hh) * p.xsh,
               p.xst, FKT, nj, P, pw, p.vec);
    cp_async_commit();
  };
  const int sr = (tid >> 4) * 4, sk = (tid & 15) * 2;
  if (count > 0) load_keys(rank, 0);
#pragma unroll 1
  for (int c = 0; c < count; ++c) {
    const int jt = rank + 2 * c, st = c & 1;
    if (c + 1 < count) {
      load_keys(jt + 2, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // key tile jt is in
    const int j0 = jt * FKT;
    const float* bs = Bs(st);
    float sc[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) sc[u][0] = sc[u][1] = 0.f;
#pragma unroll 4
    for (int n = 0; n < NP; n += 4) {
      float4 cr[4], br[2];
#pragma unroll
      for (int u = 0; u < 4; ++u) cr[u] = ld4(Cs + (sr + u) * LDN + n);
#pragma unroll
      for (int v = 0; v < 2; ++v) br[v] = ld4(bs + (sk + v) * LDN + n);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float s = sc[u][v];
#pragma unroll
          for (int k = 0; k < 4; ++k) s = fmaf(at(cr[u], k), at(br[v], k), s);
          sc[u][v] = s;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (hh >= nh) break;
      const float* sg = segs + hh * QMAX;
      float* w = Ws + hh * FRT * LDW;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + sr + u;
        if (jt < it) {                     // every pair live: factors
          const float rf = i < jend ? expf(sg[i] - sg[j0 + FKT - 1]) : 0.f;
#pragma unroll
          for (int v = 0; v < 2; ++v)
            w[(sr + u) * LDW + sk + v] =
                sc[u][v] * rf * cfs[hh * QMAX + j0 + sk + v];
        } else {                           // the diagonal: masked, then exp
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int j = j0 + sk + v;
            w[(sr + u) * LDW + sk + v] =
                j <= i && i < jend
                    ? sc[u][v] * expf(sg[i] - sg[j]) * dts[hh * QMAX + j]
                    : 0.f;
          }
        }
      }
    }
    __syncthreads();                       // both W tiles in
    if (active) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh >= nh) break;
        const float* w = Ws + hh * FRT * LDW;
        const float* xs = Xs(st, hh) + c0;
#pragma unroll
        for (int k = 0; k < FKT; k += 4) {
          const float4 b[4] = {ld4(xs + k * LDP), ld4(xs + (k + 1) * LDP),
                               ld4(xs + (k + 2) * LDP),
                               ld4(xs + (k + 3) * LDP)};
#pragma unroll
          for (int u = 0; u < TM; ++u) {
            const float4 a = ld4(w + (r0 + u) * LDW + k);
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              float s = acc[hh][u][v];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                s = fmaf(at(a, kk), at(b[kk], v), s);
              acc[hh][u][v] = s;
            }
          }
        }
      }
    }
    __syncthreads();                       // stage st and the W tiles free
  }

  // The pair's sums: the other rank's through its shared memory (its
  // stages are free now), added to this one's; y = sum + d_skip x, x from
  // the diagonal tile's stage (this row tile).
  cg::cluster_group cluster = cg::this_cluster();
  float* red = region;                               // [2][FRT][P]
  if (rank != diag && active)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int u = 0; u < TM; ++u)
        *reinterpret_cast<float4*>(red + (hh * FRT + r0 + u) * P + c0) =
            make_float4(acc[hh][u][0], acc[hh][u][1], acc[hh][u][2],
                        acc[hh][u][3]);
  cluster.sync();
  if (rank == diag && active) {
    const float* other = cluster.map_shared_rank(red, rank ^ 1);
    const float* xd = Xs((count - 1) & 1, 0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (hh >= nh) break;
      const float dsk = p.d_skip[h0 + hh];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int r = r0 + u;
        if (r >= ni) continue;
        const float4 o = ld4(other + (hh * FRT + r) * P + c0);
        const float4 xv = ld4(xd + hh * FKT * LDP + r * LDP + c0);
        const long long t = p.t0 + i0 + r;
        if (GEN && c0 >= pw) continue;
        st_f4(p.y + ((bb * (long long)p.T + t) * p.H + h0 + hh) * pf + p0 +
                  c0,
              make_float4(fmaf(dsk, xv.x, acc[hh][u][0] + o.x),
                          fmaf(dsk, xv.y, acc[hh][u][1] + o.y),
                          fmaf(dsk, xv.z, acc[hh][u][2] + o.z),
                          fmaf(dsk, xv.w, acc[hh][u][3] + o.w)),
              pw - c0, svec);
      }
    }
  }
  cluster.sync();                          // the other rank's sums are read
}

// State block: rows [n0, n0 + NS) of N of one head's state after the
// chunk, S_out = exp(seg_last) S_in + B^T (w * X) over the chunk's rows,
// the key tiles streaming through two stages. Thread: state rows n0 + NR
// (tid / PT) .. + NR - 1, channels 4 (tid % PT) .. + 3. NR = 8 (three
// shared loads per 32 multiply-adds) where N > 32; else NR = 4, so a
// small state still spreads over the block's threads.
template <int P, int NR, bool GEN>
__device__ void f32_state_block(const F32Args& p, int ns, int h, int bb,
                                float* sm) {
  using Sh = FShape<P>;
  constexpr int NS = 8 * NR;                         // state rows a block
  constexpr int LDP = Sh::LDP, PT = Sh::PT, LDB = NS + 4;
  const int N = p.N, q = p.q, nkt = (q + FKT - 1) / FKT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* dts = sm;                                   // [QMAX] dt, then seg
  float* wj = dts + QMAX;                            // [QMAX] decay * dt
  float* seg_last = wj + QMAX;                       // [4]
  float* region = seg_last + 4;
  const int stage = FKT * LDB + FKT * LDP;           // B slice, x
  auto Bt = [&](int st) { return region + st * stage; };
  auto Xt = [&](int st) { return region + st * stage + FKT * LDB; };

  const int grp = h / (p.H / p.G), n0 = ns * NS;
  const int live_n = min(NS, N - n0);
  const int p0 = GEN ? blockIdx.z * P : 0, pw = GEN ? min(P, p.pf - p0) : P;
  const int pf = GEN ? p.pf : P, svec = GEN ? p.svec : 1;
  const float* bp = p.b + bb * p.bsb + (long long)p.t0 * p.bst + grp * p.bsg +
                    n0;
  const float* xp = p.x + bb * p.xsb + (long long)p.t0 * p.xst +
                    (long long)h * p.xsh + p0;
  auto load_keys = [&](int jt) {
    const int j0 = jt * FKT, nj = min(FKT, q - j0), st = jt & 1;
    load_f32(Bt(st), LDB, bp + (long long)j0 * p.bst, p.bst, FKT, nj, NS,
             live_n, p.vec);
    load_f32(Xt(st), LDP, xp + (long long)j0 * p.xst, p.xst, FKT, nj, P, pw,
             p.vec);
    cp_async_commit();
  };
  load_keys(0);
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

  const bool active = tid < 8 * PT;
  const int nr = (tid / PT) * NR, c0 = (tid % PT) * 4;
  // The carried-in state this thread decays, fetched while the tiles land.
  const long long base = ((long long)bb * p.H + h) * N * pf + p0;
  float4 s_old[NR];
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    const int row = n0 + nr + u;
    s_old[u] = p.s_in && active && row < N && (!GEN || c0 < pw)
                   ? ld_f4(p.s_in + base + (long long)row * pf + c0,
                           pw - c0, svec)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float acc[NR][4];
#pragma unroll
  for (int u = 0; u < NR; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll 1
  for (int jt = 0; jt < nkt; ++jt) {
    if (jt + 1 < nkt) {
      load_keys(jt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // tile jt (and the weights) in
    if (active) {
      const float* bt = Bt(jt & 1) + nr;
      const float* xt = Xt(jt & 1) + c0;
      const float* w = wj + jt * FKT;
#pragma unroll 4
      for (int j = 0; j < FKT; ++j) {
        const float4 b0 = ld4(bt + j * LDB);
        const float4 b1 = NR > 4 ? ld4(bt + j * LDB + 4) : b0;
        const float4 xv = ld4(xt + j * LDP);
        const float wv = w[j];
        const float xw[4] = {xv.x * wv, xv.y * wv, xv.z * wv, xv.w * wv};
#pragma unroll
        for (int u = 0; u < NR; ++u) {
          const float bu = at(u < 4 ? b0 : b1, u & 3);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(bu, xw[v], acc[u][v]);
        }
      }
    }
    __syncthreads();                       // stage jt & 1 is free
  }
  if (!active) return;
  const float dec = expf(seg_last[0]);
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    const int row = n0 + nr + u;
    if (row >= N || (GEN && c0 >= pw)) continue;
    st_f4(p.s_out + base + (long long)row * pf + c0,
          make_float4(fmaf(s_old[u].x, dec, acc[u][0]),
                      fmaf(s_old[u].y, dec, acc[u][1]),
                      fmaf(s_old[u].z, dec, acc[u][2]),
                      fmaf(s_old[u].w, dec, acc[u][3])),
          pw - c0, svec);
  }
}

// Clusters of two blocks, longest work first: the output pairs of the
// later half of the row tiles (longest row tile first), then the state
// blocks (a row tile's worth of keys each; their count made even), then
// the output pairs of the earlier row tiles.
template <int P, bool GEN>
__global__ void __launch_bounds__(F_THREADS) ssd_kernel(F32Args p) {
  extern __shared__ __align__(16) float fsm[];
  const int bb = blockIdx.y;
  const int n_long = 2 * (p.n_rt - p.n_rt / 2) * p.n_hs;
  const int n_state = (p.n_state + 1) & ~1;
  int bx = blockIdx.x;
  if (bx >= n_long && bx < n_long + n_state) {
    const int s = bx - n_long;
    if (s < p.n_state) {
      if (p.N > 32)
        f32_state_block<P, 8, GEN>(p, s % p.n_ns, s / p.n_ns, bb, fsm);
      else
        f32_state_block<P, 4, GEN>(p, s % p.n_ns, s / p.n_ns, bb, fsm);
    }
    return;
  }
  if (bx >= n_long) bx -= n_state;
  const int pair = bx >> 1;
  f32_out_block<P, GEN>(p, p.n_rt - 1 - pair / p.n_hs, pair % p.n_hs, bx & 1,
                        bb, fsm);
}

// One launch per chunk, the column slices on the grid's z; the state
// between chunks goes through scratch, two (B, H, N, P) buffers used in
// turn.
template <int P, bool GEN>
cudaError_t launch_f32(F32Args a, int batch, int slices, int chunk,
                       const float* init, float* fin, float* scratch,
                       cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<P, GEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f32_smem_bytes<P>(GEN ? NMAX : NMAX_FIRST));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long state = (long long)batch * a.H * a.N * a.pf;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = f32_smem_bytes<P>(a.N);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  a.s_in = init;
  for (int c = 0, t0 = 0; t0 < a.T; ++c, t0 += chunk) {
    const bool last = t0 + min(chunk, a.T - t0) >= a.T;
    if (!last && !scratch) return cudaErrorInvalidValue;
    a.s_out = last ? fin : scratch + (c % 2) * state;
    const ChunkGeom g = chunk_geom(DT_F32, a.T, a.H, a.G, a.N, chunk, t0,
                                   a.s_out != nullptr);
    a.t0 = t0;
    a.q = g.q;
    a.n_hs = g.n_hs;
    a.n_ns = g.n_ns;
    a.n_rt = g.n_rt;
    a.n_yblk = g.n_yblk;
    a.n_state = g.n_state;
    cfg.gridDim = dim3(g.blocks, batch, slices);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_kernel<P, GEN>, a);
    if (e != cudaSuccess) return e;
    a.s_in = a.s_out;
  }
  return cudaSuccess;
}

// The instances this translation unit launches (see the header comment):
// GEN, and fp16 alone (SSD_HALF) or bf16 and fp32.
constexpr bool kGeneric = SSD_GENERIC;
constexpr bool kHalf = SSD_HALF;

// The compiled slice width of head dim P (0 for none): P itself where it
// is compiled, else the next compiled width, 64 for P > 64 (slices);
// ssd.cu's instances take P itself only.
inline int slice_width(int P) {
  const int w = P < 1 ? 0 : P <= 8 ? 8 : P <= 16 ? 16 : P <= 32 ? 32 : 64;
  return kGeneric || w == P ? w : 0;
}

template <typename T>
int launch_tc_any(TcArgs<T> t, int pc, int B, int slices, int chunk,
                  const float* init, float* fin, float* scratch,
                  cudaStream_t s) {
  switch (pc) {
    case 8:
      return (int)launch_tc<8, kGeneric, T>(t, B, slices, chunk, init, fin,
                                            scratch, s);
    case 16:
      return (int)launch_tc<16, kGeneric, T>(t, B, slices, chunk, init, fin,
                                             scratch, s);
    case 32:
      return (int)launch_tc<32, kGeneric, T>(t, B, slices, chunk, init, fin,
                                             scratch, s);
    default:
      return (int)launch_tc<64, kGeneric, T>(t, B, slices, chunk, init, fin,
                                             scratch, s);
  }
}

template <typename T>
int launch_tc_call(const void* x, long long xsb, long long xst,
                   long long xsh, const float* dt, long long dsb,
                   long long dst, long long dsh, const float* a_log,
                   const float* d_skip, const void* b, long long bsb,
                   long long bst, long long bsg, const void* c,
                   long long csb, long long cst, long long csg,
                   const float* init, void* y, float* fin, float* scratch,
                   int B, int T_, int H, int G, int N, int P, int pc,
                   int slices, int chunk, int vec, cudaStream_t s) {
  TcArgs<T> t{};
  t.x = static_cast<const T*>(x); t.xsb = xsb; t.xst = xst; t.xsh = xsh;
  t.dt = dt; t.dsb = dsb; t.dst = dst; t.dsh = dsh;
  t.a_log = a_log; t.d_skip = d_skip;
  t.b = static_cast<const T*>(b); t.bsb = bsb; t.bst = bst; t.bsg = bsg;
  t.c = static_cast<const T*>(c); t.csb = csb; t.cst = cst; t.csg = csg;
  t.y = static_cast<T*>(y);
  t.T = T_; t.H = H; t.G = G; t.N = N;
  t.vec = vec;
  t.pf = P; t.svec = P % 4 == 0;
  return launch_tc_any<T>(t, pc, B, slices, chunk, init, fin, scratch, s);
}

}  // namespace

// Any head dim P >= 1 (column slices of slice_width(P)), N <= NMAX, chunk
// <= QMAX (a longer one is the wrapper's sub-chunks). dtype: DT_F32 or
// DT_BF16 in ssd.cu / ssd_any.cu, DT_F16 in ssd16.cu / ssd16_any.cu; any
// other refused.
extern "C" int ssd_launch(
    const void* x, long long xsb, long long xst, long long xsh,
    const float* dt, long long dsb, long long dst, long long dsh,
    const float* a_log, const float* d_skip,
    const void* b, long long bsb, long long bst, long long bsg,
    const void* c, long long csb, long long cst, long long csg,
    const float* init, void* y, float* fin, float* scratch, int B, int T,
    int H, int G, int N, int P, int chunk, int dtype, int vec, void* stream) {
  const int pc = slice_width(P);
  if (N < 1 || N > (kGeneric ? NMAX : NMAX_FIRST) || chunk < 1 ||
      chunk > QMAX || G < 1 || H % G || pc == 0 ||
      (kHalf ? dtype != DT_F16 : dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int slices = (P + pc - 1) / pc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kHalf) {
    return launch_tc_call<__half>(x, xsb, xst, xsh, dt, dsb, dst, dsh, a_log,
                                  d_skip, b, bsb, bst, bsg, c, csb, cst, csg,
                                  init, y, fin, scratch, B, T, H, G, N, P, pc,
                                  slices, chunk, vec, s);
  } else {
    if (dtype == DT_BF16)
      return launch_tc_call<bf16>(x, xsb, xst, xsh, dt, dsb, dst, dsh, a_log,
                                  d_skip, b, bsb, bst, bsg, c, csb, cst, csg,
                                  init, y, fin, scratch, B, T, H, G, N, P, pc,
                                  slices, chunk, vec, s);
    F32Args f{};
    f.x = static_cast<const float*>(x); f.xsb = xsb; f.xst = xst; f.xsh = xsh;
    f.dt = dt; f.dsb = dsb; f.dst = dst; f.dsh = dsh;
    f.a_log = a_log; f.d_skip = d_skip;
    f.b = static_cast<const float*>(b); f.bsb = bsb; f.bst = bst; f.bsg = bsg;
    f.c = static_cast<const float*>(c); f.csb = csb; f.cst = cst; f.csg = csg;
    f.y = static_cast<float*>(y);
    f.T = T; f.H = H; f.G = G; f.N = N;
    f.vec = vec;
    f.pf = P; f.svec = P % 4 == 0;
    switch (pc) {
      case 8:
        return (int)launch_f32<8, kGeneric>(f, B, slices, chunk, init, fin,
                                            scratch, s);
      case 16:
        return (int)launch_f32<16, kGeneric>(f, B, slices, chunk, init, fin,
                                             scratch, s);
      case 32:
        return (int)launch_f32<32, kGeneric>(f, B, slices, chunk, init, fin,
                                             scratch, s);
      default:
        return (int)launch_f32<64, kGeneric>(f, B, slices, chunk, init, fin,
                                             scratch, s);
    }
  }
}

// The launches ssd_launch makes for these arguments (one per chunk of
// `chunk` rows); launches nothing. has_final: the caller wants the final
// state. plan: [0] chunks, [1] threads per block, [2] dynamic shared
// memory bytes, [3] blocks per cluster, [4] output blocks of a whole
// chunk, [5] state blocks of a chunk that writes a state, [6] blocks of
// the first chunk's grid row, [7] blocks of the last chunk's, [8] grid
// rows (sequences), [9] fp32 words of the scratch that carries the state
// between chunks (0 for one chunk), [10] column slices (the grid's z;
// [4]-[7] count one slice).
extern "C" int ssd_plan(int B, int T, int H, int G, int N, int P, int chunk,
                        int dtype, int has_final, long long* plan) {
  const int pc = slice_width(P);
  if (N < 1 || N > (kGeneric ? NMAX : NMAX_FIRST) || chunk < 1 ||
      chunk > QMAX || G < 1 || H % G || T < 1 || pc == 0)
    return (int)cudaErrorInvalidValue;
  // bf16 and fp16 share the tensor-core kernel's geometry
  const int dt = dtype == DT_BF16 || dtype == DT_F16 ? DT_BF16 : DT_F32;
  const int chunks = (T + chunk - 1) / chunk;
  const ChunkGeom first = chunk_geom(dt, T, H, G, N, chunk, 0,
                                     chunks > 1 || has_final);
  const ChunkGeom last = chunk_geom(dt, T, H, G, N, chunk,
                                    (chunks - 1) * chunk, has_final != 0);
  const ChunkGeom whole = chunk_geom(dt, chunk, H, G, N, chunk, 0, true);
  int smem = 0;
  if (dt == DT_BF16) {
    smem = pc == 8 ? tc_smem_bytes<8>(N) : pc == 16 ? tc_smem_bytes<16>(N)
           : pc == 32 ? tc_smem_bytes<32>(N) : tc_smem_bytes<64>(N);
  } else {
    smem = pc == 8 ? f32_smem_bytes<8>(N) : pc == 16 ? f32_smem_bytes<16>(N)
           : pc == 32 ? f32_smem_bytes<32>(N) : f32_smem_bytes<64>(N);
  }
  const long long out[11] = {
      chunks, dt == DT_BF16 ? TC_THREADS : F_THREADS, smem,
      dt == DT_BF16 ? 1 : 2, whole.n_yblk,
      dt == DT_BF16 ? whole.n_state : (whole.n_state + 1) & ~1,
      first.blocks, last.blocks, B,
      chunks > 1 ? 2LL * B * H * N * P : 0, (P + pc - 1) / pc};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}
