// The engine's CUDA-core main loop for Hopper, three datapaths:
//   fp32 x fp32 -> fp32 on IEEE FMAs (the fp32 engine config, Table 1's
//     design point 4),
//   int16 x int16 -> int32 on integer multiply-adds (an int16 instance's
//     conv; its GEMM runs igemm.cuh's int8 tensor-core loop on byte planes),
//     and
//   int32 x int32 -> int32 the same way (datapath.cu's GEMM and conv.cu's
//     int32 conv: the int32 inputs of an int32 accumulator),
// C = epilogue(A @ B + D), for the engine GEMM (gemm.cu: fp32) and the
// implicit-im2col conv (conv.cu: fp32 and int16), A coming through a
// loader policy (ALoad: a row-major matrix here, or conv.cu's tap gather
// of an NHWC image) as igemm.cuh's A does.
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (:81, pallas_call :105)
// and gemm_ws (:160, pallas_call :184) for fp32 inputs, and in
// src/repro/kernels/conv.py conv2d_implicit (:88, pallas_call :140) for
// fp32 and int16 inputs.
//
// One loop for both, templated on the element type: the tiles, the ring,
// the loads and the plan are the same, a quad of 4 k values is one 16-byte
// (fp32) or 8-byte (int16) copy, and only the multiply-add, the sum and
// the epilogue differ (Dp below). Why not a header of its own for int16:
// it would repeat this file's loads, ring, split and epilogue line for line.
//
// IEEE fp32: every product is an fmaf on the CUDA cores -- no TF32, no
// split into TF32 pieces -- so the fp32 engine config keeps fp32's 24-bit
// significand; only the order of the sum differs from the plain version's.
// int16: each product fits in int32 exactly, and every add (products, K
// splits, the bias) is done on unsigned words, so sums wrap modulo 2^32 as
// the plain version's and the TPU kernel's int32 dot do (a signed overflow
// would be undefined in C++, and the compiler may exploit it). A wrapping
// sum is exact in any order: no blocked sum, and OS equals WS and the plain
// version bit for bit.
// What bounds it on the H100: at the fp32 prefill shapes (M = 64-256 rows
// against 1-50 k columns) the CUDA-core fp32 rate, 67 TFLOP/s; int16 the
// INT32 multiply-add rate (64 lanes an SM, half the fp32 FMA rate); at
// decode rows (M <= 16) the bytes of B. At M = 64 a 64-row tile gives
// N / 128 tiles (8 for gemma3-1b's wq), so the tiles alone leave most SMs
// idle.
//
// The design, the GEMM's (sgemm::plan):
//   - Block tiles of 128 x 128 (256 threads), or 64 x 128 (128 threads)
//     where those pad M less (M <= 64, the M = 64 prompt). Each thread
//     holds an 8 x 8 register micro-tile: per 4 k, 8 quad loads of A and 8
//     of B from shared memory feed 256 multiply-adds.
//   - Operands by cp.async into a 4-stage ring of BK = 16 k slices: three
//     slices are in flight while one computes, and one block-wide barrier
//     per slice.
//   - A K-major in shared memory, as it lies in device memory (or as the
//     conv's gather lays it down). B in the layout it lies in: row-major
//     (K, N) weights and HWIO filters N-major (a thread's 8 columns are two
//     quads BN / 2 apart, so a quarter warp reads 128 contiguous bytes of
//     fp32), the tied unembedding's table.T K-major, never copied (a
//     thread's columns 16 apart; K-major rows are padded to 20 elements,
//     so the 8 rows a quarter warp reads fall in 8 bank groups).
//   - fp32 only, a blocked sum: each slice's 16 products per output are
//     summed apart and then added to the running sum, so the fp32 error
//     grows with K / 16 + 16 terms, not K (one chain over mamba2-1.3b's K =
//     2048 left outputs outside the fp32 tolerance against the plain
//     version).
//   - Ragged M, N and K are masked in the loads: cp.async zero-fills what
//     lies outside. Rows that are not aligned to a quad load element by
//     element instead (fp32: 4-byte cp.async copies; int16: plain loads).
//   - Split K where the tiles leave SMs idle or end in a thin last wave,
//     at least 4 slices (64 k) per split and at most 16 splits. Each split
//     writes its partial to the stream's workspace; the tile's last block,
//     found by a ticket, adds them in split order and stores the tile, in
//     the same launch (hgemm.cuh's store_partial / last_of_tile /
//     merge_partials: tickets are left at 0, so no memset).
//   - The epilogue stages the tile in shared memory and finishes it in one
//     compact loop (finishing the 64 values in registers unrolls the
//     activation 64 times, and fetching that code took longer than a short
//     split's main loop). The bias (D) is added there, once per output.
// The conv's shape (conv.cu's plan: ResNet-50's layers at batch 1 have
// too few outputs for 8 x 8 micro-tiles to give each SM 8 warps):
//   - 56 x 64 tiles of 7 x 8 micro-tiles and KG = 4 k groups of 64
//     threads on one tile: group g multiplies k quads g, g + KG, ... of
//     each slice, so a tile has KG times the warps without a split's
//     traffic; the groups' sums meet in shared memory, added in group
//     order. At most 128 registers, so two such blocks share an SM.
//   - No blocked sum: K splits keep each chain within 512 k instead (its
//     second set of accumulators held the registers the groups need).
//   - Partials lie in the workspace as the tile does (a block's stores and
//     the merge's loads contiguous, all threads merging, 4 splits' loads
//     in flight), and each thread finishes one column in a compact loop of
//     its output type, its bias loaded once, beside the groups' sums (the
//     GEMM's loop loads it for every output, each load a round trip).
// What it does not reach: an 8 x 8 micro-tile from shared memory needs a
// quarter of a word per FMA, the H100's whole shared-memory bandwidth at
// the FMA rate, and the blocked sum holds the registers a larger
// micro-tile would need; at mamba2-1.3b's in_proj (M = 256) it takes
// 1.35x torch.matmul's time (PERF.md).
// The plan depends on the shape, B's layout and the SM count only, and
// each tile is computed the same way whatever order the
// blocks walk, so WS (weight-major tile order) equals OS bit for bit, and
// a rerun equals the first run.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "hgemm.cuh"

namespace sgemm {

constexpr int BN = 128;          // the GEMM's block columns
constexpr int BK = 16;           // k per ring stage
constexpr int STAGES = 4;
constexpr int LDK = BK + 4;      // elements per K-major row
constexpr int MIN_STEPS = 4;     // stages a split walks at least
constexpr int MAX_SPLITS = 16;   // partials a tile merges at most

// The datapath of an element type: its accumulator, and whether the sum is
// blocked (fp32) or wraps in any order (int16).
template <typename In> struct Dp;
template <> struct Dp<float> {
  using Acc = float;
  static constexpr bool INT = false;
};
template <> struct Dp<int16_t> {
  using Acc = int;
  static constexpr bool INT = true;
};
// int32 inputs (datapath.cu, conv.cu): int32 multiply-adds modulo 2^32.
template <> struct Dp<int> {
  using Acc = int;
  static constexpr bool INT = true;
};

// 4 accumulator values of a quad in shared memory.
template <typename Acc> struct Q4 { Acc x, y, z, w; };
__device__ __forceinline__ Q4<float> quad(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Q4<int> quad(const int16_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return {static_cast<int>(v.x << 16) >> 16, static_cast<int>(v.x) >> 16,
          static_cast<int>(v.y << 16) >> 16, static_cast<int>(v.y) >> 16};
}
__device__ __forceinline__ Q4<int> quad(const int* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  return {v.x, v.y, v.z, v.w};
}
template <typename Acc>
__device__ __forceinline__ Acc quad_at(const Q4<Acc>& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
// c += a * b: an IEEE FMA, or a multiply-add modulo 2^32.
__device__ __forceinline__ void mac(float& c, float a, float b) {
  c = fmaf(a, b, c);
}
__device__ __forceinline__ void mac(int& c, int a, int b) {
  c = static_cast<int>(static_cast<unsigned>(c) +
                       static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

struct Plan {
  int bm, bn, bk, threads, stages, smem;
  int tiles_m, tiles_n, ksteps, splits;
  long long blocks;
  long long ws_words;   // workspace: tickets then partials, 0 for one split
};

// A block of KG groups of TY x TX threads, each thread an MR x 8
// micro-tile of the BM = MR TY by BN = 8 TX block tile; group g takes k
// quads g, g + KG, ... of every slice, and the groups' sums are added in
// group order at the end (KG > 1, the conv's: KG times the warps on a
// tile, so small convs fill the SMs with fewer K splits).
template <typename In, int MR, int TY, int TX, int KG, bool TRANS_B>
struct Shape {
  static constexpr int BM = MR * TY, BN = 8 * TX, G = TY * TX, T = G * KG;
  static constexpr int FR = MR * 8;               // outputs a thread
  static constexpr int LDN = BN + 4;              // elements per N-major row
  static constexpr int LDT = BN + 4;              // per row of the C tile
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr int B_ELEMS = TRANS_B ? BN * LDK : BK * LDN;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int RING = STAGES * STAGE * (int)sizeof(In);
  static constexpr int TILE = KG * BM * LDT * 4;  // the staged C tile(s)
  static constexpr int SMEM = RING > TILE ? RING : TILE;
  static constexpr int A_QUADS = BM * (BK / 4);   // A quads a slice
  static constexpr int A_ITEMS = (A_QUADS + T - 1) / T;   // ... a thread
  static constexpr int PER = BM * BN / T;         // KG > 1: outputs a thread
  static_assert(T % (BK / 4) == 0, "a thread's k quad is tid % 4");
  static_assert((BK / 4) % KG == 0, "k quads a group");
  static_assert(KG == 1 || (T % BN == 0 && PER * T == BM * BN),
                "KG > 1: a thread's outputs lie in one column");
};

// The GEMM's tiles: 8 x 8 micro-tiles, 128 columns, one k group.
template <typename In, int BM, bool TB>
using GemmShape = Shape<In, 8, BM / 8, BN / 8, 1, TB>;

template <typename In>
inline int smem_bytes(int bm, int b_trans) {
  if (bm == 128)
    return b_trans ? GemmShape<In, 128, true>::SMEM
                   : GemmShape<In, 128, false>::SMEM;
  return b_trans ? GemmShape<In, 64, true>::SMEM
                 : GemmShape<In, 64, false>::SMEM;
}

// The plan of a GEMM call: shape, B's layout and SM count only (and the
// element type's shared memory).
//   - 128-row tiles unless 64-row ones pad M less (M <= 64, M = 129..192):
//     a 128 x 128 tile did more per SM than two 64 x 128 ones at M = 256
//     on the H100.
//   - K splits s minimizing waves(s) * (ksteps / s + 3 + s / 8): the
//     blocks' waves over the resident slots (one 256-thread block or two
//     128-thread ones per SM, by their registers) times a split's k steps
//     plus its fill and merge, in k steps. Fitted to a sweep of s on the
//     H100 in fp32: mamba2-1.3b's in_proj (134 tiles, a thin second wave
//     unsplit) ran fastest at 4-8 splits, gemma3-1b's wq at M = 64 (8
//     tiles) at 12-16.
// The conv has a plan of its own (conv.cu).
template <typename In>
inline Plan plan(int m, int n, int k, int b_trans, int sms) {
  using hgemm::ceil_div;
  Plan p{};
  p.bm = ceil_div(m, 128) * 128 == ceil_div(m, 64) * 64 && m > 64 ? 128 : 64;
  p.bn = BN;
  p.bk = BK;
  p.threads = p.bm * BN / 64;
  p.stages = STAGES;
  p.smem = smem_bytes<In>(p.bm, b_trans);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, BN);
  p.ksteps = ceil_div(k, BK);
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  const long long slots = (long long)sms * (p.bm == 64 ? 2 : 1);
  int most = p.ksteps / MIN_STEPS;
  most = most < MAX_SPLITS ? most : MAX_SPLITS;
  if (tiles > hgemm::MAX_TICKETS) most = 1;
  int s = 1;
  double best = 0.0;
  for (int c = 1; c <= most || c == 1; ++c) {
    const double waves = (double)((tiles * c + slots - 1) / slots);
    const double cost = waves * ((double)p.ksteps / c + 3.0 + c / 8.0);
    if (c == 1 || cost < best) { best = cost; s = c; }
  }
  p.splits = s;
  p.blocks = tiles * s;
  p.ws_words = s > 1 ? hgemm::MAX_TICKETS + p.blocks * p.bm * BN : 0;
  return p;
}

// Tile codes of a plan the caller chooses (the tuner's schedule space):
// 1 for 64-row tiles, 2 for 128-row ones.
inline int tile_code(const Plan& p) { return p.bm == 128 ? 2 : 1; }

// The GEMM's plan with its tiles and K splits chosen by the caller; false
// where the kernel cannot run it: more splits than k steps or than a tile
// merges (MAX_SPLITS), or split partials past the tickets.
template <typename In>
inline bool plan_with(int m, int n, int k, int b_trans, int tile, int splits,
                      Plan& p) {
  using hgemm::ceil_div;
  if (tile != 1 && tile != 2) return false;
  p = Plan{};
  p.bm = tile == 2 ? 128 : 64;
  p.bn = BN;
  p.bk = BK;
  p.threads = p.bm * BN / 64;
  p.stages = STAGES;
  p.smem = smem_bytes<In>(p.bm, b_trans);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, BN);
  p.ksteps = ceil_div(k, BK);
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (splits < 1 || splits > MAX_SPLITS ||
      splits > (p.ksteps > 1 ? p.ksteps : 1) ||
      (splits > 1 && tiles > hgemm::MAX_TICKETS))
    return false;
  p.splits = splits;
  p.blocks = tiles * splits;
  p.ws_words = splits > 1 ? hgemm::MAX_TICKETS + p.blocks * p.bm * BN : 0;
  return true;
}

// The call's plan: its own (tile = splits = 0) or the caller's.
template <typename In>
inline bool resolve(int m, int n, int k, int b_trans, int sms, int tile,
                    int splits, Plan& p) {
  if (tile == 0 && splits == 0) {
    p = plan<In>(m, n, k, b_trans, sms);
    return true;
  }
  return plan_with<In>(m, n, k, b_trans, tile, splits, p);
}

// OutT = AnyOut: the output type is the call's (Args::out), chosen in the
// epilogue: 0 the accumulator's 32-bit type, 1 bf16 or int8, 2 fp16 or
// int16. One kernel then serves every output (the conv's instantiations).
struct AnyOut {};

template <typename In>
struct Args {
  using Acc = typename Dp<In>::Acc;
  const In* B;       // B(k, n) = B[k * ldb + n], or B[n * ldb + k] (TRANS_B)
  const Acc* D;      // bias, row stride ldd (0: one row), or null
  void* C;           // contiguous (M, N)
  int out;           // AnyOut's output code
  int M, N, K;
  long long ldb, ldd;
  int act, shift;    // shift: the int32 rounding shift
  float out_scale;   // 2^-shift, the fp32 path's
  int vec_b;         // B's rows aligned to a quad: one copy a quad
  int ws;            // weight-major tile order
  int tiles_m, tiles_n, ksteps, splits;
  Acc* part;         // splits > 1: [tile][split][partial]
  int* tickets;      // splits > 1: one per tile, 0 between calls
};

// The quad of 4 elements at src, `left` of them inside the matrix (<= 0:
// none), into the shared address dst, zeros past `left`: one cp.async of
// the whole quad when vec (src aligned to it), else element by element
// (fp32: 4-byte cp.async copies; int16: plain loads and one shared store,
// visible after the ring's next barrier like a landed copy). `safe` is any
// valid address, handed to a copy that reads nothing.
template <typename In>
__device__ __forceinline__ void load4(uint32_t dst, const In* src, int left,
                                      int vec, const In* safe) {
  constexpr int Q = 4 * (int)sizeof(In);
  if (vec) {
    const int bytes = left >= 4 ? Q : left > 0 ? (int)sizeof(In) * left : 0;
    const void* from = bytes > 0 ? static_cast<const void*>(src) : safe;
    if constexpr (Q == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(dst), "l"(from), "r"(bytes) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(dst), "l"(from), "r"(bytes) : "memory");
    return;
  }
  if constexpr (sizeof(In) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst + 4 * e), "l"(e < left ? src + e : safe),
                      "r"(e < left ? 4 : 0)
                   : "memory");
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t lo = 2 * e < left ? s[2 * e] : 0u;
      const uint32_t hi = 2 * e + 1 < left ? s[2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n"
                 :: "r"(dst), "r"(w[0]), "r"(w[1]) : "memory");
  }
}

// A as a row-major (M, K) matrix with row stride lda; vec: rows aligned to
// a quad. Loader policy (igemm.cuh's, in elements of k): row(m) once per
// tile, a cursor per thread advanced one slice per stage, load() of one
// quad into shared memory. (A loader with a stage(m0) member first stages
// what the tile reads into shared memory: conv.cu's ConvStripA.)
template <typename In>
struct MatrixA {
  const In* a;
  long long lda;
  int M, K, vec;
  struct Row {
    const In* p;
    int ok;
  };
  using Cursor = int;  // k of the thread's quad
  __device__ __forceinline__ Row row(int m) const {
    return {a + (long long)m * lda, m < M};
  }
  __device__ __forceinline__ Cursor cursor(int k) const { return k; }
  __device__ __forceinline__ void advance(Cursor& k, int by) const { k += by; }
  __device__ __forceinline__ void load(void* dst, const Row& r,
                                       Cursor k) const {
    load4<In>(hgemm::smem_u32(dst), r.p + k, r.ok ? K - k : 0, vec, a);
  }
};

template <typename In>
inline int quad_aligned(const In* p, long long ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(In)) == 0;
}

// One output after the bias: the epilogue into OutT, or into the call's
// type (AnyOut).
template <typename In, typename OutT>
__device__ __forceinline__ void store_out(const Args<In>& p, long long i,
                                          typename Dp<In>::Acc v) {
  if constexpr (std::is_same<OutT, AnyOut>::value) {
    if constexpr (Dp<In>::INT) {
      if (p.out == 1) store_out<In, int8_t>(p, i, v);
      else if (p.out == 2) store_out<In, int16_t>(p, i, v);
      else store_out<In, int>(p, i, v);
    } else {
      if (p.out == 1) store_out<In, __nv_bfloat16>(p, i, v);
      else if (p.out == 2) store_out<In, __half>(p, i, v);
      else store_out<In, float>(p, i, v);
    }
  } else if constexpr (Dp<In>::INT) {
    epi::store_int(static_cast<OutT*>(p.C), i, v, p.shift, p.act);
  } else {
    epi::store_float(static_cast<OutT*>(p.C), i, v, p.act, p.out_scale);
  }
}

// The epilogue of one column c of a KG > 1 tile, rows r0 + i T / BN from
// the staged tile at `mine` (LDT apart a row step), into OutT.
template <typename Sh, typename In, typename OutT>
__device__ __forceinline__ void finish_column(const Args<In>& p,
                                              const typename Dp<In>::Acc* mine,
                                              typename Dp<In>::Acc bias,
                                              int r0, int c) {
  constexpr int STEP = Sh::T / Sh::BN;
#pragma unroll 1
  for (int q = 0; q < Sh::PER; ++q) {
    const int r = r0 + q * STEP;
    if (r >= p.M) break;
    typename Dp<In>::Acc y = mine[q * STEP * Sh::LDT];
    if (p.D != nullptr)
      y = hgemm::add(y, p.ldd == 0 ? bias : p.D[(long long)r * p.ldd + c]);
    store_out<In, OutT>(p, (long long)r * p.N + c, y);
  }
}

// The end of a block of KG > 1 groups: the groups' tiles staged in shared
// memory and added in group order; with K split, this split's tile goes
// to the workspace as it lies (a block's stores and loads contiguous) and
// the tile's last block adds the partials in split order (its own at its
// place), U splits' loads in flight at a time; then the epilogue, each
// thread in one column (its bias loaded once) and PER rows.
template <typename Sh, typename In, typename OutT>
__device__ __forceinline__ void finish_groups(
    const Args<In>& p, const typename Dp<In>::Acc (&acc)[Sh::FR], int tid,
    int grp, int ty, int tx, int tile, int split, int m0, int n0) {
  using Acc = typename Dp<In>::Acc;
  using V4 = typename hgemm::Vec4<Acc>::type;
  constexpr int T = Sh::T, BM = Sh::BM, BN = Sh::BN, LDT = Sh::LDT;
  constexpr int MR = Sh::FR / 8, TY = Sh::G / (BN / 8), PER = Sh::PER;
  constexpr int KG = T / Sh::G;
  extern __shared__ __align__(16) float sg_smem[];
  Acc* const red = reinterpret_cast<Acc*>(sg_smem);   // [KG][BM][LDT]
  // output q of this thread: row (tid + T q) / BN, column tid % BN; its
  // bias in flight beside the sums
  const int col = tid % BN, row0 = tid / BN, c = n0 + col;
  const Acc bias =
      p.D != nullptr && p.ldd == 0 && c < p.N ? p.D[c] : Acc(0);
  __syncthreads();                                    // the ring is read
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    Acc* row = red + (grp * BM + ty + TY * i) * LDT;
    *reinterpret_cast<V4*>(row + 4 * tx) =
        V4{acc[8 * i], acc[8 * i + 1], acc[8 * i + 2], acc[8 * i + 3]};
    *reinterpret_cast<V4*>(row + BN / 2 + 4 * tx) =
        V4{acc[8 * i + 4], acc[8 * i + 5], acc[8 * i + 6], acc[8 * i + 7]};
  }
  __syncthreads();
  Acc v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const Acc* e = red + (row0 + q * (T / BN)) * LDT + col;
    v[q] = e[0];
#pragma unroll
    for (int g = 1; g < KG; ++g) v[q] = hgemm::add(v[q], e[g * BM * LDT]);
  }
  const int S = p.splits;
  if (S > 1) {
    Acc* const base = p.part + (long long)tile * S * (BM * BN) + tid;
#pragma unroll
    for (int q = 0; q < PER; ++q) base[split * (BM * BN) + q * T] = v[q];
    if (!hgemm::last_of_tile(p.tickets + tile, S)) return;
    constexpr int U = PER >= 64 ? 1 : 64 / PER;
    Acc tot[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) tot[q] = 0;
    for (int s0 = 0; s0 < S; s0 += U) {
      Acc w[U][PER];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < S && s0 + u != split)
#pragma unroll
          for (int q = 0; q < PER; ++q)
            w[u][q] = __ldcg(base + (s0 + u) * (BM * BN) + q * T);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < S)
#pragma unroll
          for (int q = 0; q < PER; ++q)
            tot[q] = hgemm::add(tot[q], s0 + u == split ? v[q] : w[u][q]);
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) v[q] = tot[q];
  }
  // back to this thread's places in the staged tile, then a compact loop
  // per output type: the epilogue's code fetched once, not PER times, and
  // the type chosen once, not per output
#pragma unroll
  for (int q = 0; q < PER; ++q) red[(row0 + q * (T / BN)) * LDT + col] = v[q];
  if (c >= p.N) return;
  const Acc* const mine = red + row0 * LDT + col;
  if constexpr (std::is_same<OutT, AnyOut>::value) {
    if constexpr (Dp<In>::INT) {
      if (p.out == 1)
        finish_column<Sh, In, int8_t>(p, mine, bias, m0 + row0, c);
      else if (p.out == 2)
        finish_column<Sh, In, int16_t>(p, mine, bias, m0 + row0, c);
      else
        finish_column<Sh, In, int>(p, mine, bias, m0 + row0, c);
    } else {
      if (p.out == 1)
        finish_column<Sh, In, __nv_bfloat16>(p, mine, bias, m0 + row0, c);
      else if (p.out == 2)
        finish_column<Sh, In, __half>(p, mine, bias, m0 + row0, c);
      else
        finish_column<Sh, In, float>(p, mine, bias, m0 + row0, c);
    }
  } else {
    finish_column<Sh, In, OutT>(p, mine, bias, m0 + row0, c);
  }
}

// BLOCKED: the fp32 GEMM's blocked sum; the conv bounds its chains by
// splitting K instead (conv.cu), and int16 wraps.
// KG > 1 (the conv): two blocks an SM, so at most 128 registers a thread.
template <typename In, int MR, int TY, int TX, int KG, bool TRANS_B,
          bool BLOCKED, typename OutT, typename ALoad>
__global__ void __launch_bounds__(TY * TX * KG, KG > 1 ? 2 : 1)
sgemm_kernel(Args<In> p, ALoad al) {
  using Sh = Shape<In, MR, TY, TX, KG, TRANS_B>;
  using Acc = typename Dp<In>::Acc;
  constexpr int T = Sh::T, BM = Sh::BM, BN = Sh::BN, FR = Sh::FR;
  constexpr int LDN = Sh::LDN, LDT = Sh::LDT, A_ITEMS = Sh::A_ITEMS;
  extern __shared__ __align__(16) float sg_smem[];
  In* const ring = reinterpret_cast<In*>(sg_smem);
  const int tid = threadIdx.x;
  const int grp = KG > 1 ? tid / Sh::G : 0, lt = KG > 1 ? tid % Sh::G : tid;
  const int ty = lt / TX, tx = lt % TX;
  const int S = p.splits, split = blockIdx.x % S, tile = blockIdx.x / S;
  int mt, nt;
  hgemm::tile_coords(tile, p.tiles_m, p.tiles_n, p.ws, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  int lo, hi;
  hgemm::split_range(split, S, p.ksteps, lo, hi);
  const int steps = hi - lo;

  if constexpr (hgemm::Staged<ALoad>::value) {
    al.stage(m0);                         // what the tile's A reads
    __syncthreads();
  }

  // A quad item e = tid + i * T: row e / 4, k (e % 4) * 4 of each slice.
  typename ALoad::Row rows[A_ITEMS];
#pragma unroll
  for (int i = 0; i < A_ITEMS; ++i)
    rows[i] = al.row(m0 + (tid + i * T) / (BK / 4));
  typename ALoad::Cursor cur = al.cursor(lo * BK + (tid % (BK / 4)) * 4);

  // One k slice (k0 = BK * step) into ring stage st; slices are loaded in
  // order, the A cursor one slice further each time.
  auto load_stage = [&](int st, int step) {
    In* as = ring + st * Sh::STAGE;
    In* bs = as + Sh::A_ELEMS;
    const int k0 = step * BK;
#pragma unroll
    for (int i = 0; i < A_ITEMS; ++i) {
      const int e = tid + i * T;
      if (Sh::A_QUADS % T == 0 || e < Sh::A_QUADS)
        al.load(as + (e / (BK / 4)) * LDK + (e % (BK / 4)) * 4, rows[i],
                cur);
    }
    al.advance(cur, BK);
#pragma unroll
    for (int e = tid; e < BN * BK / 4; e += T) {
      if constexpr (TRANS_B) {
        const int r = e / (BK / 4), kc = (e % (BK / 4)) * 4;
        const int gn = n0 + r, gk = k0 + kc;
        load4<In>(hgemm::smem_u32(bs + r * LDK + kc),
                  p.B + (long long)gn * p.ldb + gk, gn < p.N ? p.K - gk : 0,
                  p.vec_b, p.B);
      } else {
        const int r = e / (BN / 4), nc = (e % (BN / 4)) * 4;
        const int gk = k0 + r, gn = n0 + nc;
        load4<In>(hgemm::smem_u32(bs + r * LDN + nc),
                  p.B + (long long)gk * p.ldb + gn, gk < p.K ? p.N - gn : 0,
                  p.vec_b, p.B);
      }
    }
  };

  // acc[8 i + j]: C(m0 + ty + TY i, n0 + col(j)), col(j) = tx + TX j
  // (table.T) or 4 tx + j % 4 + BN / 2 (j / 4) (row-major B).
  Acc acc[FR];
#pragma unroll
  for (int i = 0; i < FR; ++i) acc[i] = 0;

  // The products of the slice in stage `it % STAGES` (this group's k
  // quads), added into c.
  auto slice = [&](int it, Acc (&c)[FR]) {
    const In* as = ring + (it % STAGES) * Sh::STAGE;
    const In* bs = as + Sh::A_ELEMS;
#pragma unroll
    for (int u = 0; u < BK / (4 * KG); ++u) {
      const int kk = 4 * (grp + KG * u);
      Q4<Acc> a[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) a[i] = quad(as + (ty + TY * i) * LDK + kk);
      Acc b[4][8];
      if constexpr (TRANS_B) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const Q4<Acc> v = quad(bs + (tx + TX * j) * LDK + kk);
          b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Q4<Acc> l = quad(bs + (kk + q) * LDN + 4 * tx);
          const Q4<Acc> h = quad(bs + (kk + q) * LDN + BN / 2 + 4 * tx);
          b[q][0] = l.x; b[q][1] = l.y; b[q][2] = l.z; b[q][3] = l.w;
          b[q][4] = h.x; b[q][5] = h.y; b[q][6] = h.z; b[q][7] = h.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const Acc av = quad_at(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) mac(c[8 * i + j], av, b[q][j]);
        }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, lo + s);
    hgemm::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    hgemm::cp_async_wait<STAGES - 2>();   // slice `it` has landed
    __syncthreads();                      // ... and slice it - 1 is read
    if (it + STAGES - 1 < steps)
      load_stage((it + STAGES - 1) % STAGES, lo + it + STAGES - 1);
    hgemm::cp_async_commit();
    if constexpr (!BLOCKED) {
      slice(it, acc);                     // one chain a split
    } else {
      // the blocked sum: a slice's products apart, then into acc
      Acc part[FR];
#pragma unroll
      for (int i = 0; i < FR; ++i) part[i] = 0;
      slice(it, part);
#pragma unroll
      for (int i = 0; i < FR; ++i) acc[i] += part[i];
    }
  }
  hgemm::cp_async_wait<0>();
  if constexpr (KG > 1) {
    finish_groups<Sh, In, OutT>(p, acc, tid, grp, ty, tx, tile, split, m0,
                                n0);
  } else {
    if (S > 1) {
      const long long stride = (long long)T * FR;
      Acc* const base = p.part + (long long)tile * S * stride + 4 * tid;
      hgemm::store_partial<FR, T, Acc>(acc, base + split * stride);
      if (!hgemm::last_of_tile(p.tickets + tile, S)) return;
      hgemm::merge_partials<FR, T, Acc>(acc, base, stride, S, split);
    }

    // The epilogue: the tile through shared memory (the ring is free), then
    // one compact loop, consecutive threads on consecutive columns.
    __syncthreads();
    Acc* tile_s = reinterpret_cast<Acc*>(sg_smem);   // [BM][LDT]
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      Acc* row = tile_s + (ty + TY * i) * LDT;
      if constexpr (TRANS_B) {
#pragma unroll
        for (int j = 0; j < 8; ++j) row[tx + TX * j] = acc[8 * i + j];
      } else {
        using V4 = typename hgemm::Vec4<Acc>::type;
        *reinterpret_cast<V4*>(row + 4 * tx) =
            V4{acc[8 * i], acc[8 * i + 1], acc[8 * i + 2], acc[8 * i + 3]};
        *reinterpret_cast<V4*>(row + BN / 2 + 4 * tx) = V4{
            acc[8 * i + 4], acc[8 * i + 5], acc[8 * i + 6], acc[8 * i + 7]};
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int e = tid; e < BM * BN; e += T) {
      const int r = m0 + e / BN, c = n0 + e % BN;
      if (r >= p.M || c >= p.N) continue;
      Acc v = tile_s[(e / BN) * LDT + e % BN];
      if (p.D != nullptr) v = hgemm::add(v, p.D[(long long)r * p.ldd + c]);
      store_out<In, OutT>(p, (long long)r * p.N + c, v);
    }
  }
}

// One launch of the kernel of that shape: `blocks` blocks, `smem` bytes of
// dynamic shared memory (the ring or the C tile, and what a staging loader
// adds).
template <typename In, int MR, int TY, int TX, int KG, bool TB, bool BLOCKED,
          typename OutT, typename ALoad>
cudaError_t launch_shape(const Args<In>& a, const ALoad& al, long long blocks,
                         int smem, cudaStream_t s) {
  auto kernel = sgemm_kernel<In, MR, TY, TX, KG, TB, BLOCKED, OutT, ALoad>;
  static int configured = 0;   // largest dynamic shared memory allowed yet
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  kernel<<<(unsigned)blocks, TY * TX * KG, smem, s>>>(a, al);
  return cudaGetLastError();
}

// The arguments of a call with plan pl: B (K, N) at ldb, D an fp32 / int32
// bias, C with output code `out` (AnyOut), workspace: pl.ws_words 4-byte
// words (tickets, then partials) owned by the calling stream, may be null
// for one split.
template <typename In>
Args<In> make_args(const Plan& pl, const In* B,
                   const typename Dp<In>::Acc* D, void* C, int out, int m,
                   int n, int k, long long ldb, long long ldd, int act,
                   int shift, float out_scale, int ws, void* workspace) {
  using Acc = typename Dp<In>::Acc;
  Args<In> a{};
  a.B = B; a.D = D; a.C = C; a.out = out;
  a.M = m; a.N = n; a.K = k;
  a.ldb = ldb; a.ldd = ldd;
  a.act = act; a.shift = shift; a.out_scale = out_scale;
  a.vec_b = quad_aligned(B, ldb);
  a.ws = ws;
  a.tiles_m = pl.tiles_m; a.tiles_n = pl.tiles_n;
  a.ksteps = pl.ksteps; a.splits = pl.splits;
  a.tickets = static_cast<int*>(workspace);
  a.part = workspace ? reinterpret_cast<Acc*>(static_cast<int*>(workspace) +
                                              hgemm::MAX_TICKETS)
                     : nullptr;
  return a;
}

// One GEMM call: A through `al`, B (K, N) at ldb (b_trans: the transpose
// of a row-major (N, K) buffer), D, C as Args says; the GEMM's plan, or
// the caller's (tile, splits: plan_with; 0, 0 for the call's own).
template <typename In, typename OutT, typename ALoad>
cudaError_t launch(const ALoad& al, const In* B,
                   const typename Dp<In>::Acc* D, OutT* C, int m, int n,
                   int k, long long ldb, int b_trans, long long ldd, int act,
                   int shift, float out_scale, int ws, void* workspace,
                   cudaStream_t s, int tile = 0, int splits = 0) {
  constexpr bool BL = !Dp<In>::INT;
  Plan pl;
  if (!resolve<In>(m, n, k, b_trans, hgemm::sm_count(), tile, splits, pl))
    return cudaErrorInvalidValue;
  if (pl.splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const Args<In> a = make_args<In>(pl, B, D, C, 0, m, n, k, ldb, ldd, act,
                                   shift, out_scale, ws, workspace);
  const long long g = pl.blocks;
  if (b_trans)
    return pl.bm == 128
               ? launch_shape<In, 8, 16, 16, 1, true, BL, OutT>(
                     a, al, g, pl.smem, s)
               : launch_shape<In, 8, 8, 16, 1, true, BL, OutT>(
                     a, al, g, pl.smem, s);
  return pl.bm == 128
             ? launch_shape<In, 8, 16, 16, 1, false, BL, OutT>(
                   a, al, g, pl.smem, s)
             : launch_shape<In, 8, 8, 16, 1, false, BL, OutT>(
                   a, al, g, pl.smem, s);
}

// The GEMM: A a row-major (M, K) matrix with row stride lda.
template <typename In, typename OutT>
cudaError_t launch_gemm(const In* A, const In* B,
                        const typename Dp<In>::Acc* D, OutT* C, int m, int n,
                        int k, long long lda, long long ldb, int b_trans,
                        long long ldd, int act, int shift, float out_scale,
                        int ws, void* workspace, cudaStream_t s,
                        int tile = 0, int splits = 0) {
  const MatrixA<In> al{A, lda, m, k, quad_aligned(A, lda)};
  return launch<In, OutT>(al, B, D, C, m, n, k, ldb, b_trans, ldd, act,
                          shift, out_scale, ws, workspace, s, tile, splits);
}

}  // namespace sgemm
