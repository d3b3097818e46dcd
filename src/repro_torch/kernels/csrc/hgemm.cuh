// bf16 x bf16 -> fp32 and fp16 x fp16 -> fp32 GEMM for Hopper: the 16-bit
// float datapaths of the engine GEMM, C = epilogue(A @ B + D), for bf16
// inputs (gemm.cu) and fp16 inputs (gemm16.cu).
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (:81, pallas_call :105)
// and gemm_ws (:160, pallas_call :184) for bf16 and fp16 inputs.
//
// The element type Elt (bf16 or __half) is a template parameter of every
// kernel: Hopper's mma.sync and wgmma take .f16 operands at the shapes
// they take .bf16, and the tensor map names its element type. Nothing
// else depends on it: the plan, the tiles, the loads (16-bit words moved
// as bits) and the sum order are the same for both.
//
// Two regimes, chosen by the shape alone (plan()), so OS and WS always run
// the same plan and every output element is summed in the same order: WS
// equals OS bit for bit, and a rerun equals the first run.
//
// Skinny, M <= 16 (every decode step: M = live slots <= 4; the static
// path's M = 1). Bound by B's bytes: each weight is used M times, so the
// call costs reading B from device memory at 3.35 TB/s, and at the
// projections' sizes (0.6-16 MB; 604 MB for the tied unembedding) the
// latency of that read. The design:
//   - K splits over blocks: the plan aims at two blocks per SM, so wk/wv
//     (N = 256) and mlp.wo (K = 6912) spread over the card; for row-major
//     B narrower than 2048 columns or whose 256-column tiles leave too few
//     blocks, the 4 warps of a block share one 64-column strip and split
//     each chunk's k instead.
//   - Loads straight into registers, 16 bytes a lane along whichever of
//     B's dimensions is contiguous (row-major (K, N) weights, or the tied
//     unembedding's (N, K) table read as table.T, never copied), 16-24 of
//     them in flight per lane: each round reads 512 contiguous bytes of
//     every B row it touches. A 4-stage cp.async ring through shared
//     memory, tried first, read the unembedding at 1.5 TB/s on the H100;
//     this reads it at 2.5 TB/s (PERF.md).
//   - Tensor cores with A and B swapped: mma.sync m16n8k16 computes C^T =
//     B^T A^T, so N fills the 16-row side and M the 8-wide side (M <= 8:
//     one MMA per 16 k; M <= 16: two). The MMA needs its two operands to
//     agree only on which k sits in which slot, so a lane's 8 loaded k of
//     table.T feed it unchanged; row-major B is paired along k with byte
//     permutes.
// Wide, M > 16 (prefill chunks of 256, a short prompt's 64, the engine's
// M up to ~12544). Towards the tensor-core rate (989 TFLOP/s bf16), bound
// by feeding it from L2 and device memory and, at the serving and engine
// shapes (a few us each), by the fixed costs around the loop: the first
// stage's arrival (~2 us), a K split's merge and the epilogue (phases by
// tools/hgemm_phases.py, PERF.md). The design:
//   - wgmma m64nNk16 (sm_90a) on operands in shared memory in the 128-byte
//     swizzled layout wgmma reads: A K-major; B K-major (table.T) or
//     MN-major (row-major weights, the descriptor's transpose bit).
//   - A block of two consumer warpgroups and one producer warp: 128-row
//     tiles, each warpgroup 64 rows of 64, 128 or 256 columns (64 for N <=
//     64, 256 where those tiles still fill the card, else 128), or for M <=
//     64 one 64 x 256 tile, each warpgroup 128 of its columns. Two
//     warpgroups share each stage's B (or A): less operand traffic per
//     flop than one on 64 x 128, and one's wgmma overlaps the other's wait.
//   - Operands by TMA into a ring of 4-8 stages (about 200 KB), all of them
//     in flight: the producer warp's lane refills a stage once the 8
//     consumer warps have released it (full / empty mbarriers); a consumer
//     never issues a copy, and each warpgroup keeps one wgmma group in
//     flight. Tensor maps are encoded once per (pointer, shape, stride,
//     box) and kept. Operands whose rows are not 16-byte aligned (no tensor
//     map) go through a cp.async ring that every thread fills.
//   - Split K by clusters: where the tiles leave SMs idle, the S splits of
//     a tile (at most 8, each at least 4 k steps) run as one cluster of S
//     blocks. Every block stages its fp32 tile in its shared memory; after
//     a cluster barrier block s adds rows [s BM / S, (s + 1) BM / S) of all
//     S tiles over distributed shared memory, in split order, and finishes
//     them. No workspace, ticket or memset: the call is capturable, two
//     streams share nothing, and every output is summed in a fixed order.
//   - The epilogue reads the staged tile in one compact loop (bias, a
//     branch-light activation with GELU / SiLU out of line, shift,
//     rounding) and stores 16 bytes a thread.
//   - Tile order: WS walks every M tile of an N strip before the next
//     strip; OS walks groups of 8 M tiles n-major, so the prefill
//     unembedding (2 M tiles) reads the 604 MB table from device memory
//     once, not once per M tile.
// Split K, skinny: each block writes its fp32 partial to the workspace
// (coalesced: a warp's 512 bytes contiguous) and takes an atomic ticket for
// its tile; the last block of a tile adds the partials in split order (its
// own from registers, 4 splits' loads in flight at a time), applies bias
// and epilogue once and stores the tile, all in the same launch. The
// tickets sit at the head of a workspace kept per stream: zeroed once when
// it is made, and each last block sets its ticket back to 0, so a call
// needs no memset and calls on two streams never share one.
// Ragged M, N and K are masked in the loads (zeros, or TMA's out-of-bounds
// fill); rows that are not 16-byte aligned are loaded element by element.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "epilogue.cuh"

namespace hgemm {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;              // k per wide stage
// skinny: k per round of loads
constexpr int SK_TRANS_CHUNK = 256;    // B = table.T
constexpr int SK_ROW_CHUNK = 64;       // row-major B
constexpr int SK_MAX_SPLITS = 32;
// wide tiles (rows x columns): two consumer warpgroups split the rows of
// a 128-row tile, or the columns of a 64-row one
enum { WIDE_128x64 = 0, WIDE_128x128 = 1, WIDE_128x256 = 2, WIDE_64x256 = 3 };
constexpr int WIDE_THREADS = 288;   // 2 consumer warpgroups + a TMA warp
constexpr int WD_MIN_STEPS = 4;     // k steps a wide split walks at least
constexpr int WD_MAX_SPLITS = 8;    // a tile's splits: one cluster of blocks
// ring depth: as many (BM + BN) x 64 stages as fit in 200 KB, at most 8
constexpr int wide_stages(int bm, int bn) {
  return 200 * 1024 / ((bm + bn) * BK * 2) < 8
             ? 200 * 1024 / ((bm + bn) * BK * 2) : 8;
}
// dynamic shared memory: the ring, or the fp32 tile staged after it (rows
// of bn + 8 floats), whichever is larger, and alignment slack
constexpr int wide_smem(int bm, int bn) {
  return (wide_stages(bm, bn) * (bm + bn) * BK * 2 > bm * (bn + 8) * 4
              ? wide_stages(bm, bn) * (bm + bn) * BK * 2
              : bm * (bn + 8) * 4) + 1024;
}
constexpr int GROUP_M = 8;          // OS order: M tiles per group
constexpr int MAX_TICKETS = 1024;   // 4-byte words ahead of the partials

struct Plan {
  int wide;             // 0: skinny (mma.sync), 1: wide (wgmma)
  int bm, bn, bk;       // block tile, k per stage (skinny: per round)
  int warps_n;          // skinny: warps side by side along N (4 or 1)
  int stages, threads, smem;  // smem: dynamic bytes
  int tiles_m, tiles_n, ksteps, splits;
  long long blocks;
  long long part_words;  // fp32 partials, 0 for one split
  long long ws_words;    // workspace: tickets then partials, 0 for one split
};

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

inline int max_clusters(int size);

// A plan's blocks and workspace from its tiles and splits: a skinny
// block's fp32 partials (32 lanes x warps x values a lane, per 8 rows),
// tickets ahead of them; a wide plan merges within its cluster.
inline void set_blocks(Plan& p, int m, int b_trans) {
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  p.blocks = tiles * p.splits;
  p.part_words = !p.wide && p.splits > 1
                     ? p.blocks * 32LL * p.warps_n * (b_trans ? 4 : 16) *
                           (m > 8 ? 2 : 1)
                     : 0;
  p.ws_words = !p.wide && p.splits > 1 ? MAX_TICKETS + p.part_words : 0;
}

// A wide plan of tile shape `shape` with `splits` K splits (0: as many as
// fill the SMs, each at least WD_MIN_STEPS k steps, at most WD_MAX_SPLITS,
// and no more than one wave of clusters: a split count whose clusters the
// card cannot hold at once, one block an SM, is cut back). The splits of a
// tile run as one cluster of blocks and add their partials over
// distributed shared memory, so a wide plan needs no workspace.
inline void plan_wide(int m, int n, int k, int shape, int splits, int sms,
                      Plan& p) {
  p.wide = 1;
  p.bm = shape == WIDE_64x256 ? 64 : 128;
  p.bn = shape == WIDE_128x64 ? 64 : shape == WIDE_128x128 ? 128 : 256;
  p.bk = BK;
  p.threads = WIDE_THREADS;
  p.stages = wide_stages(p.bm, p.bn);
  p.smem = wide_smem(p.bm, p.bn);
  p.ksteps = ceil_div(k, BK);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, p.bn);
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  int s = splits;
  if (s <= 0) {
    s = tiles < sms ? (int)(sms / tiles) : 1;
    const int most = p.ksteps / WD_MIN_STEPS;
    s = s < most ? s : most;
    s = s < WD_MAX_SPLITS ? s : WD_MAX_SPLITS;
    while (s > 1 && tiles > max_clusters(s)) --s;
  }
  s = s < WD_MAX_SPLITS ? s : WD_MAX_SPLITS;
  s = s < p.ksteps ? s : p.ksteps;
  p.splits = s > 1 ? s : 1;
  p.part_words = 0;
}

// The wide tile for a shape: the narrowest of 128 x 64, 128 x 128 and 128
// x 256 (64 x 256 for M <= 64, whose warpgroups split the columns) whose
// tiles fit one wave of blocks, else the widest (a third of 128 x 64's
// operand traffic per flop). At the serving and engine shapes the most
// tiles win: K splits fill the rest of the card (tools/hgemm_phases.py
// --sweep, PERF.md).
inline int wide_shape(int m, int n, int sms) {
  const int tm = ceil_div(m, 128);
  if ((long long)tm * ceil_div(n, 64) <= sms) return WIDE_128x64;
  if ((long long)tm * ceil_div(n, 128) <= sms) return WIDE_128x128;
  return m <= 64 ? WIDE_64x256 : WIDE_128x256;
}

// The plan of a call: shape, B's layout and SM count only.
inline Plan plan(int m, int n, int k, int b_trans, int sms) {
  Plan p{};
  if (m <= 16) {
    const int target = 2 * sms;
    p.wide = 0;
    p.bm = m > 8 ? 16 : 8;
    // Row-major B: 4 warps side by side on 256 columns (64-deep chunks)
    // where N is wide and those tiles fill the card; else 4 warps on one
    // 64-column strip splitting each chunk's k, 16 (64-deep chunks, the
    // most blocks) or 64 k a warp (256-deep chunks, where those still
    // give every SM a block: 16 loads in flight per lane).
    const long long n256 = ceil_div(n, 256);
    p.warps_n = b_trans || (n256 > 8 && n256 * ceil_div(k, 64) >= target)
                    ? 4 : 1;
    p.bk = b_trans ? SK_TRANS_CHUNK
           : p.warps_n == 4 ||
                   (long long)ceil_div(n, 64) * ceil_div(k, 256) < sms
               ? SK_ROW_CHUNK : 4 * SK_ROW_CHUNK;
    p.bn = (b_trans ? 16 : 64) * p.warps_n;
    p.stages = 1;
    p.threads = 128;
    p.smem = 0;
    p.ksteps = ceil_div(k, p.bk);
    p.tiles_m = 1;
    p.tiles_n = ceil_div(n, p.bn);
    int s = ceil_div(target, p.tiles_n);
    s = s < p.ksteps ? s : p.ksteps;
    s = s < SK_MAX_SPLITS ? s : SK_MAX_SPLITS;
    p.splits = s > 1 ? s : 1;
  } else {
    plan_wide(m, n, k, wide_shape(m, n, sms), 0, sms, p);
  }
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (!p.wide && tiles > MAX_TICKETS) p.splits = 1;
  set_blocks(p, m, b_trans);
  return p;
}

// Tile codes of a plan the caller chooses (the tuner's schedule space):
// the skinny kernel, or TILE_WIDE0 + a wide shape (WIDE_*).
enum { TILE_SKINNY = 1, TILE_WIDE0 = 2 };

inline int tile_code(const Plan& p) {
  if (!p.wide) return TILE_SKINNY;
  return TILE_WIDE0 + (p.bm == 64 ? WIDE_64x256 : p.bn == 64 ? WIDE_128x64
                       : p.bn == 128 ? WIDE_128x128 : WIDE_128x256);
}

// The plan of a call with its tile and K splits chosen by the caller;
// false where the kernels cannot run it: the skinny kernel above M = 16,
// a wide tile at M <= 16, more splits than k steps or than the kernel
// merges (SK_MAX_SPLITS, WD_MAX_SPLITS), skinny partials past the
// tickets, or clusters of `splits` wide blocks the card cannot hold.
inline bool plan_with(int m, int n, int k, int b_trans, int sms, int tile,
                      int splits, Plan& p) {
  if (splits < 1) return false;
  if (tile == TILE_SKINNY) {
    if (m > 16) return false;
    p = plan(m, n, k, b_trans, sms);
    const long long tiles = (long long)p.tiles_m * p.tiles_n;
    if (splits > SK_MAX_SPLITS || splits > (p.ksteps > 1 ? p.ksteps : 1) ||
        (splits > 1 && tiles > MAX_TICKETS))
      return false;
    p.splits = splits;
    set_blocks(p, m, b_trans);
    return true;
  }
  const int shape = tile - TILE_WIDE0;
  if (m <= 16 || shape < WIDE_128x64 || shape > WIDE_64x256) return false;
  p = Plan{};
  plan_wide(m, n, k, shape, splits, sms, p);
  if (p.splits != splits || (splits > 1 && max_clusters(splits) < 1))
    return false;
  set_blocks(p, m, b_trans);
  return true;
}

// The call's plan: its own (tile = splits = 0) or the caller's.
inline bool resolve(int m, int n, int k, int b_trans, int sms, int tile,
                    int splits, Plan& p) {
  if (tile == 0 && splits == 0) {
    p = plan(m, n, k, b_trans, sms);
    return true;
  }
  return plan_with(m, n, k, b_trans, sms, tile, splits, p);
}

template <typename Elt>
struct Args {
  const Elt* A;      // (M, K), row stride lda
  const Elt* B;      // B(k, n) = B[k * ldb + n], or B[n * ldb + k] (TRANS_B)
  const float* D;    // fp32 bias, row stride ldd (0: one row), or null
  void* C;           // contiguous (M, N)
  int M, N, K;
  long long lda, ldb, ldd;
  int act;
  float out_scale;
  int vec_a, vec_b;  // rows 16-byte aligned: vector / TMA loads, else elements
  int ws;            // weight-major tile order
  int tiles_m, tiles_n, ksteps, splits;
  float* part;       // splits > 1: [tile][split][partial]
  int* tickets;      // splits > 1: one per tile, 0 between calls
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Element-wise form of load_chunk, for rows that are not 16-byte aligned
// (kept out of line: the aligned path is the hot one).
static __device__ __noinline__ void load_chunk_slow(uint32_t dst,
                                                    const void* src,
                                                    int left) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < left ? s[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < left ? s[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 8 consecutive elements at src, `left` of them inside the matrix (<= 0:
// none), into the 16 bytes at shared address dst, zeros past `left`: by
// cp.async (src 16-byte aligned) when vec, else element by element. `safe`
// is any valid address, handed to a cp.async that reads nothing.
__device__ __forceinline__ void load_chunk(uint32_t dst, const void* src,
                                           int left, int vec,
                                           const void* safe) {
  if (!vec) {
    load_chunk_slow(dst, src, left);
    return;
  }
  const int bytes = left >= 8 ? 16 : left > 0 ? 2 * left : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(bytes > 0 ? src : safe), "r"(bytes)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 or fp16 in, fp32 accumulate.
#define HG_MMA(TY)                                                    \
  asm volatile(                                                       \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "      \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"       \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename Elt>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<Elt, bf16>::value)
    HG_MMA("bf16");
  else
    HG_MMA("f16");
}
#undef HG_MMA

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32, a warpgroup's fragments) += A (64 x 16) B (16 x 128).
// TRANS: 0 B K-major, 1 B MN-major.
// (One asm text for both element types, which the instruction names.)
#define HG_WGMMA_128(TY)                                            \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %66, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
      "%64, %65, p, 1, 1, 0, %67;\n"                                \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS)                        \
      : "memory")
template <typename Elt, int TRANS>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  if constexpr (std::is_same<Elt, bf16>::value)
    HG_WGMMA_128("bf16");
  else
    HG_WGMMA_128("f16");
}
#undef HG_WGMMA_128

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 256 fp32) += A (64 x 16) B (16 x 256); TRANS as wgmma_128.
// (One asm text for both element types, which the instruction names.)
#define HG_WGMMA_256(TY)                                            \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %130, 0;\n"                                   \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                    \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                    \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                    \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                    \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                    \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                \
      "%104, %105, %106, %107, %108, %109, %110, %111, "            \
      "%112, %113, %114, %115, %116, %117, %118, %119, "            \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "           \
      "%128, %129, p, 1, 1, 0, %131;\n"                             \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),         \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),         \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),         \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),         \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),         \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),         \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),         \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),         \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),     \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),     \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),     \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),     \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),     \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),     \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])      \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS)                        \
      : "memory")
template <typename Elt, int TRANS>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  if constexpr (std::is_same<Elt, bf16>::value)
    HG_WGMMA_256("bf16");
  else
    HG_WGMMA_256("f16");
}
#undef HG_WGMMA_256

// d (64 x 64 fp32) += A (64 x 16) B (16 x 64); TRANS as wgmma_128.
#define HG_WGMMA_64(TY)                                             \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %34, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                   \
      "%32, %33, p, 1, 1, 0, %35;\n"                                \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])          \
      : "l"(da), "l"(db), "r"(1), "n"(TRANS)                        \
      : "memory")
template <typename Elt, int TRANS>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (std::is_same<Elt, bf16>::value)
    HG_WGMMA_64("bf16");
  else
    HG_WGMMA_64("f16");
}
#undef HG_WGMMA_64

// The BN-wide product of one warpgroup.
template <typename Elt, int BN, int TRANS>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) wgmma_64<Elt, TRANS>(d, da, db);
  else if constexpr (BN == 128) wgmma_128<Elt, TRANS>(d, da, db);
  else wgmma_256<Elt, TRANS>(d, da, db);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` from the copies signalling bar.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// TMA: the box at (x inner, y outer) of the tensor map into shared dst,
// completing on bar; out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar)
      : "memory");
}

// fp32 value of output (r, c) with bias, activation and shift, rounded to
// the output type: epilogue.cuh's float path.
template <typename OutT, typename Elt>
__device__ __forceinline__ OutT finish(const Args<Elt>& p, int r, int c,
                                       float v) {
  if (p.D != nullptr) v += p.D[(long long)r * p.ldd + c];
  return epi::to<OutT>(epi::activate(v, p.act) * p.out_scale);
}

// Whether an A-loader policy stages what a tile reads into shared memory
// before the main loop (a stage(m0) member, which leaves its copies landed:
// conv.cu's ConvStripA); the kernel then takes a barrier.
template <typename L, typename = void>
struct Staged : std::false_type {};
template <typename L>
struct Staged<L, std::void_t<decltype(&L::stage)>> : std::true_type {};

// The k steps [lo, hi) of split `split` of `splits` over `ksteps`.
__device__ __forceinline__ void split_range(int split, int splits, int ksteps,
                                            int& lo, int& hi) {
  lo = (int)((long long)split * ksteps / splits);
  hi = (int)((long long)(split + 1) * ksteps / splits);
}

// Publish this block's partial (already stored), take the tile's ticket;
// true in every thread of the block that finishes the tile last, which
// has then acquired every other block's partial. The last block sets the
// ticket back to 0 for the next call on this stream.
__device__ __forceinline__ bool last_of_tile(int* ticket, int splits) {
  __shared__ int last;
  __threadfence();                         // release the partial
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();               // acquire the others'
  return last;
}

// A split's partial tile in the workspace: vector i (4 values) of thread
// tid's fragment at vector i * T + tid, so a warp's stores and loads are
// 512 contiguous bytes. V: float, or int for sgemm.cuh's int16 datapath,
// whose adds wrap modulo 2^32 (add()).
template <typename V> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <int FR, int T, typename V = float>
__device__ __forceinline__ void store_partial(const V* acc, V* part) {
  using V4 = typename Vec4<V>::type;
  V4* dst = reinterpret_cast<V4*>(part);
#pragma unroll
  for (int i = 0; i < FR / 4; ++i)
    dst[i * T] = V4{acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                    acc[4 * i + 3]};
}

// The last block of a tile: acc (FR values, this thread's fragment) becomes
// the sum of the S partials in split order, its own split `own` taken from
// acc; part is this thread's first vector in split 0, `stride` values
// between splits. The loads of 4 splits go out before their sums, so the
// merge waits about S / 4 round trips to L2, not S.
template <int FR, int T, typename V = float>
__device__ __forceinline__ void merge_partials(V* acc, const V* part,
                                               long long stride, int S,
                                               int own) {
  using V4 = typename Vec4<V>::type;
  constexpr int PIECE = FR < 16 ? FR : 16;
#pragma unroll
  for (int b = 0; b < FR; b += PIECE) {
    V tot[PIECE];
#pragma unroll
    for (int i = 0; i < PIECE; ++i) tot[i] = 0;
    for (int s0 = 0; s0 < S; s0 += 4) {
      V4 v[4][PIECE / 4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u;
        if (s < S && s != own) {
          const V4* ps =
              reinterpret_cast<const V4*>(part + s * stride) + b / 4 * T;
#pragma unroll
          for (int i = 0; i < PIECE / 4; ++i) v[u][i] = __ldcg(ps + i * T);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u;
        if (s >= S) break;
        if (s == own) {
#pragma unroll
          for (int i = 0; i < PIECE; ++i) tot[i] = add(tot[i], acc[b + i]);
        } else {
#pragma unroll
          for (int i = 0; i < PIECE / 4; ++i) {
            tot[4 * i] = add(tot[4 * i], v[u][i].x);
            tot[4 * i + 1] = add(tot[4 * i + 1], v[u][i].y);
            tot[4 * i + 2] = add(tot[4 * i + 2], v[u][i].z);
            tot[4 * i + 3] = add(tot[4 * i + 3], v[u][i].w);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PIECE; ++i) acc[b + i] = tot[i];
  }
}

// ---------------------------------------------------------------------------
// skinny: M <= 16, mma.sync with A and B swapped, operands straight from
// device memory into registers
// ---------------------------------------------------------------------------
// 8 consecutive elements at p, `left` of them inside the matrix (<= 0:
// none), zeros past `left`: one 16-byte load when vec (p 16-byte aligned),
// else element by element. B is read once (no L1 allocation); A is read by
// every block (cached).
template <bool STREAM>
__device__ __forceinline__ uint4 ld8(const void* p, int left, int vec) {
  if (vec && left >= 8) {
    uint4 v;
    if (STREAM)
      asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    else
      v = __ldg(reinterpret_cast<const uint4*>(p));
    return v;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < left ? s[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < left ? s[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 2 consecutive elements of A at p, `left` of them inside (<= 0: none).
__device__ __forceinline__ uint32_t ld2(const void* p, int left) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  const uint32_t lo = left > 0 ? __ldg(s) : 0u;
  const uint32_t hi = left > 1 ? __ldg(s + 1) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Skinny block shapes: WN warps side by side along N (4), or 4 warps on
// one strip (WN = 1) each taking KW consecutive 16-deep steps of a chunk,
// their sums added in warp order at the end; a chunk is the k range one
// round of loads covers.
//   table.T (TRANS_B): a warp owns 16 rows of B's (N, K) buffer; lane
//     (g, t) loads rows g and g + 8 and A's row g at k + 8t for 8 chunks
//     of 32 k: 512 contiguous bytes of each row per warp and chunk. The
//     MMA only needs the two operands to agree on which k sits in which
//     slot, so the 8 loaded k feed two m16n8k16 MMAs unchanged.
//   row-major B: a warp owns 64 columns; lane (g, t) loads 8 columns at
//     k rows 2t, 2t + 1, 2t + 8, 2t + 9 of 4 steps of 16 k (512
//     contiguous bytes of each k row per block), pairs the k rows with
//     byte permutes, and runs 4 MMAs per step, one per column of its 8.
template <typename Elt, bool TRANS_B, int WN, int KW, int MT, typename OutT>
__global__ void __launch_bounds__(128)
skinny_kernel(const Args<Elt> p) {
  constexpr int BN = (TRANS_B ? 16 : 64) * WN;
  constexpr int WK = 4 / WN;               // warps splitting a chunk's k
  constexpr int CHUNK = TRANS_B ? SK_TRANS_CHUNK : 16 * KW * WK;
  constexpr int FN = TRANS_B ? 1 : 4;      // MMA row groups per warp
  constexpr int U = TRANS_B ? CHUNK / 32 / WK : KW;
  __shared__ float red[WK > 1 ? 4 * 32 * FN * MT * 4 : 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wn = WN == 1 ? 0 : warp, wk = WN == 1 ? warp : 0;
  const int S = p.splits, split = blockIdx.x % S, tile = blockIdx.x / S;
  const int n0 = tile * BN;
  int c_lo, c_hi;
  split_range(split, S, p.ksteps, c_lo, c_hi);

  float acc[FN][MT][4];
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][t][i] = 0.f;

  if (TRANS_B) {
    const int r0 = n0 + 16 * wn + g, r1 = r0 + 8;
    const Elt* b0 = p.B + (long long)(r0 < p.N ? r0 : 0) * p.ldb;
    const Elt* b1 = p.B + (long long)(r1 < p.N ? r1 : 0) * p.ldb;
    for (int c = c_lo; c < c_hi; ++c) {
      uint4 vb0[U], vb1[U], va[MT][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = c * CHUNK + 32 * (u * WK + wk) + 8 * t4, left = p.K - k;
        vb0[u] = ld8<true>(b0 + k, r0 < p.N ? left : 0, p.vec_b);
        vb1[u] = ld8<true>(b1 + k, r1 < p.N ? left : 0, p.vec_b);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int m = 8 * t + g;
          va[t][u] = ld8<false>(p.A + (long long)(m < p.M ? m : 0) * p.lda + k,
                                m < p.M ? left : 0, p.vec_a);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {word(vb0[u], 2 * h), word(vb1[u], 2 * h),
                                 word(vb0[u], 2 * h + 1),
                                 word(vb1[u], 2 * h + 1)};
#pragma unroll
          for (int t = 0; t < MT; ++t)
            mma16<Elt>(acc[0][t], a, word(va[t][u], 2 * h),
                     word(va[t][u], 2 * h + 1));
        }
    }
  } else {
    const int nc = n0 + 64 * wn + 8 * g;     // this lane's 8 columns
    for (int c = c_lo; c < c_hi; ++c) {
      uint4 vb[U][4];
      uint32_t va[MT][U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kb = c * CHUNK + 16 * (wk * KW + u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + 2 * t4 + (j & 1) + 8 * (j >> 1);
          vb[u][j] = ld8<true>(p.B + (long long)(k < p.K ? k : 0) * p.ldb + nc,
                               k < p.K ? p.N - nc : 0, p.vec_b);
        }
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int m = 8 * t + g;
          const Elt* ar = p.A + (long long)(m < p.M ? m : 0) * p.lda;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = kb + 2 * t4 + 8 * h;
            va[t][u][h] = ld2(ar + k, m < p.M ? p.K - k : 0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // column 8g + f is row g of this MMA, 8g + 4 + f row g + 8
          const uint32_t sel = f & 1 ? 0x7632 : 0x5410;
          const int w = f >> 1;
          const uint32_t a[4] = {
              __byte_perm(word(vb[u][0], w), word(vb[u][1], w), sel),
              __byte_perm(word(vb[u][0], w + 2), word(vb[u][1], w + 2), sel),
              __byte_perm(word(vb[u][2], w), word(vb[u][3], w), sel),
              __byte_perm(word(vb[u][2], w + 2), word(vb[u][3], w + 2), sel)};
#pragma unroll
          for (int t = 0; t < MT; ++t)
            mma16<Elt>(acc[f][t], a, va[t][u][0], va[t][u][1]);
        }
    }
  }

  constexpr int FR = FN * MT * 4;          // a thread's accumulators
  constexpr int OWNERS = 32 * WN;          // threads holding the block's sums
  float* const flat = &acc[0][0][0];
  // The k-splitting warps of one column strip add up in warp order.
  if (WK > 1) {
#pragma unroll
    for (int i = 0; i < FR; ++i) red[(warp * 32 + lane) * FR + i] = flat[i];
    __syncthreads();
    if (warp == 0)
      for (int w = 1; w < WK; ++w)
#pragma unroll
        for (int i = 0; i < FR; ++i) flat[i] += red[(w * 32 + lane) * FR + i];
  }
  const bool owner = tid < OWNERS;
  if (S > 1) {
    // Lanes whose rows all lie past M hold zeros: they store and merge
    // nothing.
    const bool live = owner && 2 * t4 < p.M;
    const long long stride = (long long)OWNERS * FR;
    float* const base = p.part + (long long)tile * S * stride + 4 * tid;
    if (live) store_partial<FR, OWNERS>(flat, base + split * stride);
    if (!last_of_tile(p.tickets + tile, S)) return;
    if (live) merge_partials<FR, OWNERS>(flat, base, stride, S, split);
  }
  if (!owner) return;

  // acc[f][t][i]: C(m = 8t + 2(lane % 4) + i % 2, n), n = n0 + 16 wn +
  // lane / 4 + 8(i / 2) (table.T), or n0 + 64 wn + 8(lane / 4) + f +
  // 4(i / 2) (row-major B).
  OutT* C = static_cast<OutT*>(p.C);
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 8 * t + 2 * t4 + (i & 1);
        const int n = TRANS_B ? n0 + 16 * wn + g + 8 * (i >> 1)
                              : n0 + 64 * wn + 8 * g + f + 4 * (i >> 1);
        if (m < p.M && n < p.N)
          C[(long long)m * p.N + n] = finish<OutT>(p, m, n, acc[f][t][i]);
      }
}

// ---------------------------------------------------------------------------
// wide: M > 16, wgmma on 128-byte swizzled tiles fed by a TMA warp
// ---------------------------------------------------------------------------
// Tile t of the grid in OS (groups of GROUP_M M tiles, n-major inside a
// group) or WS order (all M tiles of an N strip, then the next strip).
__device__ __forceinline__ void tile_coords(int t, int tm, int tn, int ws,
                                            int& mt, int& nt) {
  if (ws) {
    nt = t / tm;
    mt = t % tm;
    return;
  }
  const int group = t / (GROUP_M * tn), first = group * GROUP_M;
  const int size = tm - first < GROUP_M ? tm - first : GROUP_M;
  const int r = t - group * GROUP_M * tn;
  mt = first + r % size;
  nt = r / size;
}

// Per stage: A (BM x 64, K-major: row r at r * 128 bytes, 16-byte chunk c
// at (c ^ r % 8) * 16), then B: K-major as A (BN rows n), or MN-major as
// BN / 64 blocks of 64 columns, each 64 k rows (row k at k * 128, chunk c
// at (c ^ k % 8) * 16). Every 8 rows are one 1024-byte swizzle atom: the
// layout TMA writes with 128-byte swizzle and wgmma reads. Warpgroup w
// multiplies rows 64 w of A by all of B (WM = 2), or all 64 rows of A by
// columns BN / 2 w of B (WM = 1): WBN columns each.
template <int WM, int BN>
struct WideShape {
  static constexpr int BM = 64 * WM, WBN = WM == 2 ? BN : BN / 2;
  static constexpr int ST = wide_stages(BM, BN);
  static constexpr int A_BYTES = BM * BK * 2, STAGE = (BM + BN) * BK * 2;
  static constexpr int CLD = BN + 8;   // floats per staged row: no conflicts
  static constexpr int SMEM = wide_smem(BM, BN);
};

// Activations past ReLU (ReLU6, GELU, SiLU) out of line, so the
// epilogue's loop, unrolled over a store's values, stays short.
static __device__ __noinline__ float activate_rare(float x, int act) {
  return epi::activate(x, act);
}
__device__ __forceinline__ float activate_wide(float x, int act) {
  return act == epi::ACT_NONE   ? x
         : act == epi::ACT_RELU ? fmaxf(x, 0.f)
                                : activate_rare(x, act);
}

// Two fp32 values rounded to the 16-bit output type, as one 32-bit word
// (round to nearest even; an fp16 overflow is +-inf).
template <typename OutT>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same<OutT, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ void add4(float4& v, const float4& w) {
  v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
}

// The block of a K split's cluster that finishes the tile's rows [lo, hi):
// their sums over the S blocks' staged tiles in split order, bias,
// activation, shift and rounding, 16-byte stores. The values stay in
// float4 registers end to end: an array reinterpreted for the 16-byte store
// would be placed in local memory.
template <typename Elt, typename OutT, int BM, int BN, int CLD>
__device__ __forceinline__ void finish_rows(const Args<Elt>& p,
                                            const float* cs,
                                            const float* bias_row, int S,
                                            int lo, int hi, int m0, int n0) {
  constexpr int VEC = 16 / (int)sizeof(OutT), CPR = BN / VEC;
  constexpr int NV = VEC / 4;                  // float4s per store
  OutT* C = static_cast<OutT*>(p.C);
  const bool vec_c = p.N % VEC == 0;
  const float* D = p.D;
  const long long ldd = p.ldd;
  const int act = p.act;
  const float scale = p.out_scale;
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll 1
  for (int q = threadIdx.x; q < (hi - lo) * CPR; q += WIDE_THREADS) {
    const int r = lo + q / CPR, c = (q % CPR) * VEC;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= p.M || gc >= p.N) continue;
    const float* own = cs + r * CLD + c;
    float4 v[NV];
    if (S == 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        v[i] = *reinterpret_cast<const float4*>(own + 4 * i);
    } else {
      // every split's loads in flight at once, then the sums in split order
      float4 w[WD_MAX_SPLITS][NV];
#pragma unroll
      for (int s = 0; s < WD_MAX_SPLITS; ++s) {
        if (s >= S) break;
        const float* ps = cluster.map_shared_rank(own, s);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          w[s][i] = *reinterpret_cast<const float4*>(ps + 4 * i);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = w[0][i];
#pragma unroll
      for (int s = 1; s < WD_MAX_SPLITS; ++s) {
        if (s >= S) break;
#pragma unroll
        for (int i = 0; i < NV; ++i) add4(v[i], w[s][i]);
      }
    }
    const bool whole = vec_c && gc + VEC <= p.N;
    const int live = whole ? VEC : min(VEC, p.N - gc);
    if (bias_row != nullptr) {       // the tile's bias row, zeros past N
#pragma unroll
      for (int i = 0; i < NV; ++i)
        add4(v[i], *reinterpret_cast<const float4*>(bias_row + c + 4 * i));
    } else if (D != nullptr) {
      const float* d = D + (long long)gr * ldd + gc;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        v[i].x += 4 * i < live ? d[4 * i] : 0.f;
        v[i].y += 4 * i + 1 < live ? d[4 * i + 1] : 0.f;
        v[i].z += 4 * i + 2 < live ? d[4 * i + 2] : 0.f;
        v[i].w += 4 * i + 3 < live ? d[4 * i + 3] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i].x = activate_wide(v[i].x, act) * scale;
      v[i].y = activate_wide(v[i].y, act) * scale;
      v[i].z = activate_wide(v[i].z, act) * scale;
      v[i].w = activate_wide(v[i].w, act) * scale;
    }
    OutT* dst = C + (long long)gr * p.N + gc;
    if (whole) {
      if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float4*>(dst) = v[0];
      } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack2<OutT>(v[0].x, v[0].y), pack2<OutT>(v[0].z, v[0].w),
                       pack2<OutT>(v[1].x, v[1].y), pack2<OutT>(v[1].z, v[1].w));
      }
    } else {
      for (int e = 0; e < live; ++e)
        dst[e] = epi::to<OutT>(lane4(e < 4 ? v[0] : v[NV - 1], e & 3));
    }
  }
}

// Block: warpgroups 0 and 1 multiply, warp 8 (the producer) keeps the ring
// full. TMA: one lane of the producer refills a stage once all 8 consumer
// warps have released it (full / empty mbarriers, no block-wide barrier in
// the loop); each warpgroup keeps one wgmma group in flight. Without
// tensor maps (rows not 16-byte aligned) every thread copies 16-byte
// chunks into a cp.async ring (or element by element) and the block
// barriers once per stage. Split s of a tile's S runs as block s of a
// cluster; after the loop every block stages its fp32 tile in shared
// memory and finishes BM / S of the tile's rows (finish_rows).
template <typename Elt, bool TRANS_B, int WM, int BN, bool TMA, typename OutT>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
wide_kernel(const Args<Elt> p, const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_b) {
  using Sh = WideShape<WM, BN>;
  constexpr int BM = Sh::BM, WBN = Sh::WBN, ST = Sh::ST, CLD = Sh::CLD;
  constexpr int L = ST - 2;          // cp.async: stages loaded ahead
  constexpr int A_BYTES = Sh::A_BYTES, STAGE = Sh::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];   // TMA: stage s has landed
  __shared__ __align__(8) uint64_t empty[ST];  // TMA: every warp is done with s
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (sbase - raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;            // 0, 1: consumers; 2: the producer
  const int S = p.splits, split = blockIdx.x % S, t = blockIdx.x / S;
  int mt, nt;
  tile_coords(t, p.tiles_m, p.tiles_n, p.ws, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  int s_lo, s_hi;
  split_range(split, S, p.ksteps, s_lo, s_hi);
  const int nsteps = s_hi - s_lo;
  const int wm = WM == 2 ? wg : 0, wn = WM == 2 ? 0 : wg;
  // A bias row (16-byte aligned) goes to shared memory by cp.async from
  // the producer warp while the loop runs; the epilogue reads it there.
  __shared__ __align__(16) float bias_s[BN];
  const bool row_bias = p.D != nullptr && p.ldd == 0 &&
                        (reinterpret_cast<uintptr_t>(p.D) & 15) == 0;
  auto load_bias = [&]() {
    for (int c = 4 * lane; c < BN; c += 128) {
      const int left = p.N - (n0 + c);
      const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(bias_s + c)),
                      "l"(bytes > 0 ? p.D + n0 + c : p.D), "r"(bytes)
                   : "memory");
    }
  };

  auto load = [&](int stage, int step) {
    const int k0 = step * BK;
    const uint32_t sa = sbase + stage * STAGE, sb = sa + A_BYTES;
    if constexpr (TMA) {                     // the producer's lane 0 only
      const uint32_t bar = smem_u32(&full[stage]);
      mbar_expect(bar, STAGE);
      tma_2d(sa, &tma_a, k0, m0, bar);
      if (TRANS_B) {
        tma_2d(sb, &tma_b, k0, n0, bar);
      } else {
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_2d(sb + h * (BK * 128), &tma_b, n0 + 64 * h, k0, bar);
      }
    } else {
#pragma unroll 1
      for (int q = tid; q < BM * 8; q += WIDE_THREADS) {
        const int r = q >> 3, c = q & 7;
        const int gr = m0 + r, k = k0 + 8 * c;
        const int left = gr < p.M ? p.K - k : 0;
        load_chunk(sa + r * 128 + ((c ^ (r & 7)) << 4),
                   left > 0 ? p.A + (long long)gr * p.lda + k : p.A, left,
                   p.vec_a, p.A);
      }
#pragma unroll 1
      for (int q = tid; q < BN * 8; q += WIDE_THREADS) {
        if (TRANS_B) {
          const int r = q >> 3, c = q & 7, gn = n0 + r, k = k0 + 8 * c;
          const int left = gn < p.N ? p.K - k : 0;
          load_chunk(sb + r * 128 + ((c ^ (r & 7)) << 4),
                     left > 0 ? p.B + (long long)gn * p.ldb + k : p.B, left,
                     p.vec_b, p.B);
        } else {
          constexpr int CH = BN / 8;           // 16-byte chunks per k row
          const int kr = q / CH, c = q % CH, gk = k0 + kr, gn = n0 + 8 * c;
          const int left = gk < p.K ? p.N - gn : 0;
          load_chunk(sb + (c >> 3) * (BK * 128) + kr * 128 +
                         (((c & 7) ^ (kr & 7)) << 4),
                     left > 0 ? p.B + (long long)gk * p.ldb + gn : p.B, left,
                     p.vec_b, p.B);
        }
      }
    }
  };

  float acc[WBN / 2];
#pragma unroll
  for (int i = 0; i < WBN / 2; ++i) acc[i] = 0.f;

  // One k step: the warpgroup's 64 x WBN product from stage `stage`.
  auto mma_stage = [&](int stage) {
    const uint32_t sa = sbase + stage * STAGE + wm * (64 * 128);
    const uint32_t sb = sbase + stage * STAGE + A_BYTES + wn * (WBN * 128);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t da = sw128_desc(sa + 32 * j, 16, 1024);
      const uint64_t db = TRANS_B ? sw128_desc(sb + 32 * j, 16, 1024)
                                  : sw128_desc(sb + 2048 * j, BK * 128, 1024);
      wgmma_bn<Elt, WBN, TRANS_B ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
  };

  if constexpr (TMA) {
    // The producer's lane sets up the barriers and puts the first ST
    // stages in flight before the block's one barrier; then it refills a
    // stage once all 8 consumer warps have released it.
    if (wg == 2) {
      if (lane == 0) {
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&tma_a)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&tma_b)) : "memory");
        for (int i = 0; i < ST; ++i) {
          mbar_init(smem_u32(&full[i]), 1);
          mbar_init(smem_u32(&empty[i]), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int i = 0; i < ST && i < nsteps; ++i) load(i, s_lo + i);
      }
      if (row_bias) load_bias();
      cp_async_commit();
      __syncwarp();
    }
    __syncthreads();                 // the barriers are set up
    if (wg == 2) {
      for (int i = ST; i < nsteps; ++i) {
        if (lane == 0) {
          mbar_wait(smem_u32(&empty[i % ST]), ((i / ST) - 1) & 1);
          load(i % ST, s_lo + i);
        }
        __syncwarp();
      }
      cp_async_wait<0>();            // the bias row
    } else {
      for (int i = 0; i < nsteps; ++i) {
        mbar_wait(smem_u32(&full[i % ST]), (i / ST) & 1);
        mma_stage(i % ST);
        wgmma_wait<1>();               // the product of step i - 1 is done
        if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(i - 1) % ST]));
      }
      wgmma_wait<0>();
    }
  } else {
    if (wg == 2 && row_bias) load_bias();    // with stage 0's group
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
      if (i < nsteps) load(i, s_lo + i);
      cp_async_commit();
    }
    for (int i = 0; i < nsteps; ++i) {
      cp_async_wait<L - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();   // stage i landed; every group of stage i - 2 is done
      if (wg < 2) mma_stage(i % ST);
      if (i + L < nsteps) load((i + L) % ST, s_lo + i + L);
      cp_async_commit();
      if (wg < 2) wgmma_wait<1>();
    }
    if (wg < 2) wgmma_wait<0>();
    cp_async_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < WBN / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
  __syncthreads();                   // the ring is free for the C tile

  // acc[4j + 2h + v]: C(64 wm + 16 (warp % 4) + lane / 4 + 8h, WBN wn + 8j
  // + 2 (lane % 4) + v) of the tile, staged in fp32.
  float* const cs = reinterpret_cast<float*>(smem);
  if (wg < 2) {
    const int r = 64 * wm + 16 * (warp & 3) + (lane >> 2);
    const int c = WBN * wn + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (r + 8 * h) * CLD + c + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  if (S == 1) {
    __syncthreads();
    finish_rows<Elt, OutT, BM, BN, CLD>(p, cs, row_bias ? bias_s : nullptr,
                                        1, 0, BM, m0, n0);
    return;
  }
  // Each block of the cluster finishes BM / S rows of the tile from all S
  // staged tiles; none leaves while the others may still read its tile.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  finish_rows<Elt, OutT, BM, BN, CLD>(p, cs, row_bias ? bias_s : nullptr,
                                      S, split * BM / S, (split + 1) * BM / S,
                                      m0, n0);
  cluster.sync();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = v > 0 ? v : 132;
  }
  return cached[dev];
}

// Shared memory above the default 48 KB needs the kernel's attribute, set
// once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured = true;
  return e;
}

// Clusters of `size` wide blocks (one an SM: the wide kernels' shared
// memory) that the current card holds at once; cached per card and size.
inline int max_clusters(int size) {
  static int cached[64][WD_MAX_SPLITS + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (size < 1 || size > WD_MAX_SPLITS) return 0;
  if (cached[dev][size] == 0) {
    auto kernel = wide_kernel<bf16, false, 1, 256, true, bf16>;
    static bool configured = false;
    int n = 0;
    if (allow_smem(kernel, wide_smem(64, 256), configured) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(size);
      cfg.blockDim = dim3(WIDE_THREADS);
      cfg.dynamicSmemBytes = wide_smem(64, 256);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = size;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
        n = 0;
    }
    cudaGetLastError();              // a refused query leaves no error
    cached[dev][size] = n > 0 ? n : sm_count() / size;
  }
  return cached[dev][size];
}

template <typename Elt, bool TB, int MT, typename OutT>
cudaError_t launch_skinny(const Args<Elt>& a, const Plan& pl, cudaStream_t s) {
  const unsigned grid = (unsigned)pl.blocks;
  if (TB || pl.warps_n == 4)
    skinny_kernel<Elt, TB, 4, 4, MT, OutT><<<grid, 128, 0, s>>>(a);
  else if (pl.bk == SK_ROW_CHUNK)
    skinny_kernel<Elt, TB, 1, 1, MT, OutT><<<grid, 128, 0, s>>>(a);
  else
    skinny_kernel<Elt, TB, 1, 4, MT, OutT><<<grid, 128, 0, s>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

struct MapKey {
  uintptr_t ptr;
  uint64_t inner, outer, stride;
  uint32_t box_inner, box_outer;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer &&
           stride == o.stride && box_inner == o.box_inner &&
           box_outer == o.box_outer;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {k.inner, k.outer, k.stride,
                       (uint64_t)k.box_inner << 32 | k.box_outer})
      h = (h ^ v) * 0x100000001b3ull;
    return (size_t)h;
  }
};

// The 128-byte-swizzled tensor map of a row-major (outer, inner) matrix of
// Elt (bf16 or fp16) with a row stride of `stride` elements, read in boxes
// of (box_inner, box_outer). A map depends on these numbers alone (each
// element type keeps its own maps), so it is encoded once per distinct key
// and kept: a weight keeps its map across calls, and an activation buffer
// that the caching allocator hands out again finds its map made. False
// where cuTensorMapEncodeTiled refuses it.
template <typename Elt>
bool tensor_map(const Elt* ptr, uint64_t inner, uint64_t outer,
                uint64_t stride, uint32_t box_inner, uint32_t box_outer,
                CUtensorMap& out) {
  constexpr CUtensorMapDataType dtype =
      std::is_same<Elt, bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), inner, outer, stride,
                   box_inner, box_outer};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    out = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  if (fn(&out, dtype, 2, const_cast<Elt*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();   // bounded
  cache.emplace(key, out);
  return true;
}

// A wide launch: one block per (tile, K split), the splits of a tile one
// cluster (blocks t * S .. t * S + S - 1).
template <typename Elt, bool TB, int WM, int BN, bool TMA, typename OutT>
cudaError_t launch_wide_kernel(const Args<Elt>& a, const Plan& pl,
                               const CUtensorMap& ta, const CUtensorMap& tb,
                               cudaStream_t s) {
  auto kernel = wide_kernel<Elt, TB, WM, BN, TMA, OutT>;
  constexpr int smem = WideShape<WM, BN>::SMEM;
  static bool configured = false;
  const cudaError_t e = allow_smem(kernel, smem, configured);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)pl.blocks);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.splits > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, a, ta, tb);
  return le != cudaSuccess ? le : cudaGetLastError();
}

// TMA where both operands allow a tensor map (rows 16-byte aligned), else
// the cp.async ring.
template <typename Elt, bool TB, int WM, int BN, typename OutT>
cudaError_t launch_wide(const Args<Elt>& a, const Plan& pl, cudaStream_t s) {
  CUtensorMap ta{}, tb{};
  const bool tma =
      a.vec_a && a.vec_b && a.K > 0 &&
      tensor_map(a.A, a.K, a.M, a.lda, BK, 64 * WM, ta) &&
      (TB ? tensor_map(a.B, a.K, a.N, a.ldb, BK, BN, tb)
          : tensor_map(a.B, a.N, a.K, a.ldb, 64, BK, tb));
  return tma ? launch_wide_kernel<Elt, TB, WM, BN, true, OutT>(a, pl, ta, tb, s)
             : launch_wide_kernel<Elt, TB, WM, BN, false, OutT>(a, pl, ta, tb,
                                                               s);
}

template <typename Elt, bool TB, typename OutT>
cudaError_t dispatch(const Args<Elt>& a, const Plan& pl, cudaStream_t s) {
  if (pl.wide) {
    if (pl.bm == 64) return launch_wide<Elt, TB, 1, 256, OutT>(a, pl, s);
    return pl.bn == 64    ? launch_wide<Elt, TB, 2, 64, OutT>(a, pl, s)
           : pl.bn == 128 ? launch_wide<Elt, TB, 2, 128, OutT>(a, pl, s)
                          : launch_wide<Elt, TB, 2, 256, OutT>(a, pl, s);
  }
  return a.M > 8 ? launch_skinny<Elt, TB, 2, OutT>(a, pl, s)
                 : launch_skinny<Elt, TB, 1, OutT>(a, pl, s);
}

// One call; Elt: bf16 or __half. workspace: the plan's ws_words 4-byte
// words (tickets, then partials), owned by the calling stream; null where
// the plan needs none (one skinny split, or any wide plan). tile, splits:
// the caller's plan (plan_with), or 0, 0 for the call's own.
template <typename Elt, typename OutT>
cudaError_t launch(const Elt* A, const Elt* B, const float* D, OutT* C,
                   int m, int n, int k, long long lda, long long ldb,
                   int b_trans, long long ldd, int act, float out_scale,
                   int ws, void* workspace, cudaStream_t s, int tile = 0,
                   int splits = 0) {
  Plan pl;
  if (!resolve(m, n, k, b_trans, sm_count(), tile, splits, pl))
    return cudaErrorInvalidValue;
  if (pl.ws_words > 0 && workspace == nullptr) return cudaErrorInvalidValue;
  Args<Elt> a{};
  a.A = A; a.B = B; a.D = D; a.C = C;
  a.M = m; a.N = n; a.K = k;
  a.lda = lda; a.ldb = ldb; a.ldd = ldd;
  a.act = act; a.out_scale = out_scale;
  a.vec_a = lda % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  a.vec_b = ldb % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  a.ws = ws;
  a.tiles_m = pl.tiles_m; a.tiles_n = pl.tiles_n;
  a.ksteps = pl.ksteps; a.splits = pl.splits;
  a.tickets = static_cast<int*>(workspace);
  a.part = workspace ? static_cast<float*>(workspace) + MAX_TICKETS : nullptr;
  return b_trans ? dispatch<Elt, true, OutT>(a, pl, s)
                 : dispatch<Elt, false, OutT>(a, pl, s);
}

}  // namespace hgemm
