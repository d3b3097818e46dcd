// The mma.sync main loop on Hopper's tensor cores for 8- and 16-bit
// inputs: int8 x int8 -> int32 and int16 x int16 -> int32 (the latter as
// four int8 products of byte planes, below), shared by gemm.cu (gemm_os,
// gemm_ws: int8), gemm16.cu (the same: int16) and conv.cu
// (conv2d_implicit: int8), and bf16 / fp16 x the same -> fp32, conv.cu's
// conv2d_implicit for those inputs (the 16-bit float GEMMs run hgemm.cuh).
//
// The loop's geometry is in bytes: a ring stage holds a 64-byte k slab of A
// and B, an MMA step takes 32 bytes of k. mma.sync m16n8k32 (s8) and
// m16n8k16 (bf16, f16) lay their A and B fragments out alike in bytes, so
// the A loaders and the ldmatrix reads of A serve both widths unchanged
// (a 16-bit A is loaded as bytes: 2 a value). What differs (Dp below):
//   - row-major B: int8 slabs are transposed to [n][k] in shared memory
//     (4 x 4 byte blocks); 16-bit slabs stay [k][n] and are read with
//     ldmatrix.trans;
//   - the accumulator: int32, every add wrapping; fp32 for 16-bit float
//     inputs, whose K split partials are added in split order (so a rerun
//     equals the first run) and whose epilogue is the float one
//     (activation, 2^-shift, rounding to fp32 / bf16 / fp16).
//
// int16 on the int8 tensor cores (Hopper has no int16 MMA): each value is
// a = a_h * 2^8 + a_l, a_h = a >> 8 signed (s8), a_l = a & 0xff unsigned
// (u8), and B alike, so
//   A B = 2^16 A_h B_h + 2^8 (A_h B_l + A_l B_h) + A_l B_l,
// four mma.sync m16n8k32 products (.s8.s8, .s8.u8, .u8.s8, .u8.u8) into
// three int32 accumulators, combined on unsigned words after the loop:
// modulo 2^32, every step is exact, so the result equals the plain
// version's wrapped int32 sum bit for bit (at K = 4608, ResNet-50's
// largest, each partial sum even fits int32 unwrapped). The operands load
// as 16-bit ones (bf16's byte geometry: A by ldmatrix, row-major B [k][n]
// by ldmatrix.trans, an (N, K) B [n][k] by ldmatrix); one 64-byte slab
// (32 k) is one m16n8k32 step, whose s8 fragments are gathered from two
// 16-bit fragments by __byte_perm (the low bytes of four values into one
// u8 x 4 register, the high bytes into one s8 x 4). That permutes k inside
// the step -- lane quad t holds k {2t, 2t+1, 2t+8, 2t+9} of each 16-k half
// where the MMA expects k 4t..4t+3 -- but A and B take the same
// permutation, and an integer sum is exact in any order. The bias goes
// into the A_l B_l accumulator (weight 1), the K split partials are the
// combined int32 values, so split-K, its tickets and the epilogue are the
// int8 path's. The bound is the int8 tensor rate over the four products,
// a quarter of the int8 rate, far above the CUDA cores' INT32 lanes.
//
// C = epilogue(A @ B + D): A (M, K) comes through a loader policy (a
// row-major matrix, or conv.cu's implicit-im2col gather of an NHWC image),
// B (K, N) by its strides (row-major weights and HWIO filters, or the
// transpose of a row-major (N, K) buffer), D an int32 bias (one row
// broadcast, or a full (M, N) matrix), and the epilogue of epilogue.cuh
// (rounding shift, activation, saturation) runs once per output element.
//
// Numerics, int8 and int16: mma.sync .s32 without .satfinite, and every
// other int32 add here (the planes' combine, K splits merged, the bias)
// wraps modulo 2^32, as the plain version's (float64-exact sum wrapped to
// int32) and the TPU kernel's int32 dot do. A wrapping int sum is
// order-free: the bits depend neither on the split count nor on the merge
// order nor on where the bias goes in, so OS equals WS, and the kernel the
// plain version, bit for bit. Keep it so: no saturating add anywhere
// before the epilogue.
//
// What bounds it on the H100: ResNet-50 at batch 1 does 0.1-0.24 GOP a
// layer against a few hundred KB of image and filter, the quickstart 2.1
// GOP against 1.5 MB: operations at the int8 tensor rate (1979 TOP/s) in
// principle; in practice a layer's few microseconds go to latency (the
// launch, the first slab's round trip, a split's ticket and merge, the
// epilogue) and to the rate at which an SM's cp.async copies land (14-19
// GB/s an SM at these tiles; PERF.md, section 5). The design:
//   - A plan from the shape alone (plan(): M, N, K and B's layout; both
//     dataflows take it): 16 x 64 tiles of 4 warps for M <= 16 (the
//     classifier at batch 1), else 64 x 64 tiles of 8 warps (on the H100,
//     4 warps on that tile were slower, and 128 x 128 tiles no faster at
//     the quickstart with a longer split-K tail). K splits over blocks
//     from a waves x k-steps model (fill and merge counted in k steps).
//   - Loads in flight: a 4-stage ring of 64-byte k slabs in shared memory,
//     filled by 16-byte cp.async copies; ragged rows, ragged K and the
//     conv's padding become zero-fill through the copy's source size,
//     nothing is padded in memory. Rows that are not 16-byte aligned take
//     8- or 4-byte copies, and only rows with no 4-byte alignment (the
//     stem's K = 147) a byte path of plain loads.
//   - B k-contiguous, as mma wants it: a (N, K) buffer is copied as it is;
//     row-major (K, N) weights land as [k][n] in a staging slot of the ring
//     (16-byte chunks XOR-swizzled by k / 4, so the transpose reads with at
//     most 2-way bank conflicts) and are transposed shared to shared by 4 x
//     4 byte blocks (__byte_perm) into a double buffer one slab ahead of
//     the MMAs, which read it with ldmatrix.
//   - The bias is preloaded into split 0's accumulator, its loads in
//     flight beside the first slabs (added in the epilogue, its round trip
//     sat on every layer's critical path).
//   - Split K: each split stores its int32 partial in the stream's
//     workspace and takes a ticket for its tile (tickets are left at 0,
//     no memset: hgemm.cuh's protocol, with release and acquire on the
//     ticket's atomic instead of two fences); the tile's last block adds
//     the partials (wrapping, several partials' loads in flight at once)
//     and runs the epilogue, in the same launch.
//   - The epilogue stages the int32 tile in shared memory and stores
//     16-byte rows of int8 (or of int32).
// Tile orders (hgemm::tile_coords), one tile a block, the splits of a tile
// side by side: output-stationary (gemm_os) walks tiles in groups of 8 M
// tiles; weight-stationary (gemm_ws) walks them weight-major, all M tiles
// of one N strip before the next. Both take the same plan, so each tile is
// computed the same way in both orders. WS keeps no B strip resident in
// shared memory across M tiles: at ResNet-50's and the quickstart's
// shapes B's strips sit in L2 anyway, and one block per SM, the grid that
// residency needs, measured slower than OS on the H100 (PERF.md, section 7).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"
#include "hgemm.cuh"

namespace igemm {

// The datapath of an input type: the accumulator, and whether it is the
// wrapping int32 one.
template <typename In> struct Dp {       // bf16, __half
  using Acc = float;
  static constexpr bool INT = false;
};
template <> struct Dp<int8_t> {
  using Acc = int;
  static constexpr bool INT = true;
};
template <> struct Dp<int16_t> {         // on byte planes
  using Acc = int;
  static constexpr bool INT = true;
};

constexpr int BK = 64;          // k bytes per ring stage
constexpr int PAD = 16;         // bytes of padding per shared row
constexpr int LDA = BK + PAD;   // A rows and [n][k] B rows of a stage
constexpr int MAX_SPLITS = 16;  // partials a tile merges at most
constexpr int FILL = 3;         // a split's fill and drain, in k steps

enum Regime { SKINNY = 0, SQUARE = 1 };

// Block tile, warps (WM x WN), ring stages and the blocks an SM holds
// (registers and shared memory allow it; __launch_bounds__ holds the
// compiler to it).
template <int R> struct Cfg;
template <> struct Cfg<SKINNY> {
  static constexpr int BM = 16, BN = 64, WM = 1, WN = 4, STAGES = 4,
                       PER_SM = 4;
};
template <> struct Cfg<SQUARE> {
  static constexpr int BM = 64, BN = 64, WM = 2, WN = 4, STAGES = 4,
                       PER_SM = 2;
};

// Bytes of a row-major B slab of es-byte elements: BK / es k rows of bn
// elements and PAD bytes.
__host__ __device__ constexpr int b_slab(int bn, int es) {
  return BK / es * (bn * es + PAD);
}

// Shared memory bytes of a block: the ring (per stage an A slab and a B
// slab: [n][k] for a (N, K) buffer, a [k][n] staging slab for row-major
// B), then, for int8 row-major B, a double buffer of one slab transposed.
inline int smem_bytes(int bm, int bn, int stages, int b_trans, int es) {
  const int stage = bm * LDA + (b_trans ? bn * LDA : b_slab(bn, es));
  return stages * stage + (b_trans || es > 1 ? 0 : 2 * bn * LDA);
}

struct Plan {
  int regime, bm, bn, threads, stages, smem;
  int tiles_m, tiles_n, ksteps, splits;
  long long blocks;
  long long ws_words;    // workspace: tickets then partials, 0 for one split
};

template <int R>
inline int set_regime(Plan& p) {
  p.regime = R;
  p.bm = Cfg<R>::BM;
  p.bn = Cfg<R>::BN;
  p.threads = 32 * Cfg<R>::WM * Cfg<R>::WN;
  p.stages = Cfg<R>::STAGES;
  return Cfg<R>::PER_SM;
}

// The plan of a call: (M, N, K), B's layout and the card's SM count only;
// k counts bytes (K elements of es bytes: es K), and es sets the shared
// memory.
//   - 16 x 64 tiles of 4 warps for M <= 16, else 64 x 64 tiles of 8 warps.
//   - K splits s minimizing waves(s) * (ksteps / s + FILL) + (s - 1) *
//     merge: the blocks' waves over the resident slots times a split's k
//     steps plus its fill, and the last block's reads of the other
//     partials (a partial's bytes over a k step's operand bytes, halved:
//     the merge keeps more loads in flight than a k step).
inline Plan plan(int m, int n, int k, int b_trans, int sms, int es = 1) {
  using hgemm::ceil_div;
  Plan p{};
  const int ksteps = k > 0 ? ceil_div(k, BK) : 1;
  const int per_sm = m <= 16 ? set_regime<SKINNY>(p) : set_regime<SQUARE>(p);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, p.bn);
  p.ksteps = ksteps;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  const long long slots = (long long)sms * per_sm;
  const double merge = 0.5 * p.bm * p.bn * 4 / ((p.bm + p.bn) * BK);
  int most = std::min(ksteps, MAX_SPLITS);
  if (tiles > hgemm::MAX_TICKETS) most = 1;
  int s = 1;
  double best = 0.0;
  for (int c = 1; c <= most; ++c) {
    const double waves = (double)((tiles * c + slots - 1) / slots);
    const double cost = waves * (ceil_div(ksteps, c) + FILL) + (c - 1) * merge;
    if (c == 1 || cost < best) { best = cost; s = c; }
  }
  p.splits = s;
  p.smem = smem_bytes(p.bm, p.bn, p.stages, b_trans, es);
  p.blocks = tiles * s;
  p.ws_words = s > 1 ? hgemm::MAX_TICKETS + tiles * s * p.bm * p.bn : 0;
  return p;
}

// Tile codes of a plan the caller chooses (the tuner's schedule space):
// the regime plus one.
inline int tile_code(const Plan& p) { return p.regime + 1; }

// The plan of a call (k in bytes, as plan()) with its regime's tiles
// (tile: SKINNY + 1 or SQUARE + 1, at any M) and K splits chosen by the
// caller; false where the kernel cannot run it: more splits than k steps
// or than a tile merges (MAX_SPLITS), or split partials past the tickets.
inline bool plan_with(int m, int n, int k, int b_trans, int es, int tile,
                      int splits, Plan& p) {
  using hgemm::ceil_div;
  if (tile != SKINNY + 1 && tile != SQUARE + 1) return false;
  p = Plan{};
  if (tile == SKINNY + 1) set_regime<SKINNY>(p);
  else set_regime<SQUARE>(p);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, p.bn);
  p.ksteps = k > 0 ? ceil_div(k, BK) : 1;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (splits < 1 || splits > MAX_SPLITS || splits > p.ksteps ||
      (splits > 1 && tiles > hgemm::MAX_TICKETS))
    return false;
  p.splits = splits;
  p.smem = smem_bytes(p.bm, p.bn, p.stages, b_trans, es);
  p.blocks = tiles * splits;
  p.ws_words =
      splits > 1 ? hgemm::MAX_TICKETS + tiles * splits * p.bm * p.bn : 0;
  return true;
}

// Output codes: int8 inputs OUT_32 int32, OUT_8 int8, OUT_16 int16;
// 16-bit inputs OUT_32 fp32, OUT_BF16 bf16, OUT_16 fp16.
enum { OUT_32 = 0, OUT_8 = 1, OUT_16 = 2, OUT_BF16 = 3 };

template <typename In>
struct Args {
  using Acc = typename Dp<In>::Acc;
  const In* B;      // B(k, n) = B[k * ldb + n], or B[n * ldb + k] (b_trans)
  long long ldb;
  int gb;           // bytes per copy of B: 16, 8, 4, or 1 (plain loads)
  const Acc* D;     // bias, row stride ldd (0: one row), or null
  long long ldd;
  void* C;          // contiguous (M, N), of the output code `out`
  int out, vec_c;   // vec_c: C 16-byte aligned and rows of whole vectors
  int M, N, K, shift, act;  // K in elements
  float out_scale;  // 16-bit inputs: 2^-shift
  int tiles_m, tiles_n, ksteps, splits;
  int ws;           // weight-major tile order
  int* tickets;     // splits > 1: one per tile, 0 between calls
  Acc* part;        // splits > 1: [tile][split][partial]
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
#define IGEMM_MMA8(AT, BT)                                                 \
  asm volatile(                                                           \
      "mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "           \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

// c += a (16 x 32) b (32 x 8) on 8-bit operands, each signed (SA, SB: s8)
// or unsigned (u8); int32 sums, wrapping.
template <bool SA = true, bool SB = true>
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  if constexpr (SA && SB) IGEMM_MMA8("s8", "s8");
  else if constexpr (SA) IGEMM_MMA8("s8", "u8");
  else if constexpr (SB) IGEMM_MMA8("u8", "s8");
  else IGEMM_MMA8("u8", "u8");
}
#undef IGEMM_MMA8

// Byte planes of four 16-bit values (two registers of 16-bit pairs, x the
// first two): the high bytes (s8 x 4) and the low bytes (u8 x 4).
__device__ __forceinline__ unsigned hi_bytes(unsigned x, unsigned y) {
  return __byte_perm(x, y, 0x7531);
}
__device__ __forceinline__ unsigned lo_bytes(unsigned x, unsigned y) {
  return __byte_perm(x, y, 0x6420);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void set_byte(uint4& v, int e, int8_t x) {
  unsigned* w = reinterpret_cast<unsigned*>(&v);
  w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(x)) << (8 * (e & 3));
}

// cp.async of g = 16, 8 or 4 bytes (src g-aligned), `bytes` of them read
// and the rest zero-filled; `bytes` = 0 reads nothing (src may be any
// aligned address then).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int g, int bytes) {
  if (g == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  else if (g == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// The 16 bytes at src, `left` of them inside the matrix (<= 0: none), into
// the 16 shared bytes at dst, zeros past `left`: cp.async pieces of g
// bytes, or for g = 1 plain byte loads and one shared store (visible after
// the ring's next barrier, like a landed copy). `safe`: an address any
// copy may name.
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src,
                                       int left, int g, const int8_t* safe) {
  if (g == 16) {
    const int b = min(max(left, 0), 16);
    cp_async(hgemm::smem_u32(dst), b > 0 ? src : safe, 16, b);
    return;
  }
  if (g == 1) {
    uint4 v = make_uint4(0, 0, 0, 0);
    for (int e = 0; e < 16 && e < left; ++e) set_byte(v, e, src[e]);
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const uint32_t d = hgemm::smem_u32(dst);
  for (int o = 0; o < 16; o += g) {
    const int b = min(max(left - o, 0), g);
    cp_async(d + o, b > 0 ? src + o : safe, g, b);
  }
}

// The largest copy (16, 8, 4 or 1 bytes) that rows at stride ld from p
// allow.
inline int granule(const void* p, long long ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | (uintptr_t)ld;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

// A as a row-major (M, K) matrix with row stride lda, g its copy granule.
// (A loader with a stage(m0) member first stages what the tile reads into
// shared memory after the plan's own: conv.cu's ConvStripA.)
struct MatrixA {
  const int8_t* a;
  long long lda;
  int M, K, g;
  struct Row {
    const int8_t* p;
    int ok;
  };
  using Cursor = int;  // k of the thread's chunk
  __device__ __forceinline__ Row row(int m) const {
    return {a + (long long)m * lda, m < M};
  }
  __device__ __forceinline__ Cursor cursor(int k) const { return k; }
  __device__ __forceinline__ void advance(Cursor& k, int by) const { k += by; }
  __device__ __forceinline__ void load(int8_t* dst, const Row& r,
                                       Cursor k) const {
    copy16(dst, r.p + k, r.ok ? K - k : 0, g, a);
  }
};

// 4 x 4 byte blocks of the [k][n] staging slab st (row stride BN + PAD,
// 16-byte chunks swizzled by k / 4) into [n][k] rows of dst (stride LDA).
template <int BN, int NT>
__device__ __forceinline__ void transpose_b(const int8_t* st, int8_t* dst) {
  constexpr int LDS = BN + PAD;
  constexpr int KQ = BK / 4;
#pragma unroll
  for (int item = threadIdx.x; item < KQ * (BN / 4); item += NT) {
    const int kq = item % KQ, nq = item / KQ;
    const int8_t* s = st + 4 * kq * LDS + 16 * ((nq >> 2) ^ (kq & 3)) +
                      4 * (nq & 3);
    unsigned r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = *reinterpret_cast<const unsigned*>(s + e * LDS);
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
    unsigned* d = reinterpret_cast<unsigned*>(dst + 4 * nq * LDA + 4 * kq);
    constexpr int w = LDA / 4;
    d[0] = __byte_perm(t0, t2, 0x5410);
    d[w] = __byte_perm(t0, t2, 0x7632);
    d[2 * w] = __byte_perm(t1, t3, 0x5410);
    d[3 * w] = __byte_perm(t1, t3, 0x7632);
  }
}

// Take the tile's ticket once this block's partial is stored; true in
// every thread of the block that finishes the tile last, which then sees
// every other block's partial. Release and acquire ride on the ticket's
// atomic (thread 0, after the block's barrier), not on two full fences as
// in hgemm::last_of_tile: a split's tail is a few microseconds here, and
// the fences cost one of them. The last block sets the ticket back to 0
// for the next call on this stream.
__device__ __forceinline__ bool last_block(int* ticket, int splits) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(ticket) : "memory");
    last = old == splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  return last;
}

// One int32 output after the bias: rounding shift, activation.
__device__ __forceinline__ int finish(int v, int shift, int act) {
  return epi::activate_int(epi::rounding_shift(v, shift), act);
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// One 16-byte run of G = 16 / sizeof(OutT) outputs of a staged row, src
// the accumulators: one vector store when whole, else the `left` of them
// inside the matrix, one by one. y(v) finishes one value.
template <typename OutT, typename Acc, typename Y>
__device__ __forceinline__ void store_run(OutT* C, const Acc* src, int left,
                                          bool whole, Y y) {
  constexpr int G = 16 / (int)sizeof(OutT);
  OutT v[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    v[q] = y(src[q]);
    if (!whole && q < left) C[q] = v[q];
  }
  if (whole) *reinterpret_cast<uint4*>(C) = *reinterpret_cast<const uint4*>(v);
}

template <typename In, int R, bool TRANS_B, typename ALoad>
__global__ void __launch_bounds__(32 * Cfg<R>::WM * Cfg<R>::WN,
                                  Cfg<R>::PER_SM)
kernel(Args<In> p, ALoad al) {
  using CF = Cfg<R>;
  using Acc = typename Dp<In>::Acc;
  constexpr bool INT = Dp<In>::INT;
  constexpr int ES = (int)sizeof(In), KE = BK / ES;  // k values a slab
  // int16: four int8 products of byte planes, a slab one m16n8k32 step.
  constexpr bool PLANES = INT && ES == 2;
  // int8 row-major B is transposed to [n][k] a slab ahead of the MMAs;
  // 16-bit row-major B is read [k][n] by ldmatrix.trans.
  constexpr bool XPOSE = INT && ES == 1 && !TRANS_B;
  constexpr int BM = CF::BM, BN = CF::BN, NT = 32 * CF::WM * CF::WN;
  constexpr int LDB = BN * ES + PAD;  // bytes per k row of a [k][n] slab
  constexpr int STAGES = CF::STAGES;
  constexpr int WTM = BM / CF::WM, WTN = BN / CF::WN;
  constexpr int FM = WTM / 16, FN = WTN / 8;
  constexpr int A_BYTES = BM * LDA;
  constexpr int STAGE = A_BYTES + (TRANS_B ? BN * LDA : b_slab(BN, ES));
  constexpr int A_ITEMS = (BM * (BK / 16) + NT - 1) / NT;
  constexpr int LDC = BN + 4;  // int32 words per row of the staged C tile
  static_assert(FN % 2 == 0 && NT % 4 == 0, "warp tile");
  static_assert(BM * LDC * 4 <= STAGES * STAGE, "C tile must fit the ring");
  extern __shared__ __align__(128) int8_t ig_smem[];
  // Row-major B transposed: a double buffer of one slab after the ring.
  int8_t* const bt_base = ig_smem + STAGES * STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / CF::WN) * WTM, wn0 = (warp % CF::WN) * WTN;
  const int S = p.splits, split = blockIdx.x % S;
  int mt, nt;
  hgemm::tile_coords(blockIdx.x / S, p.tiles_m, p.tiles_n, p.ws, mt, nt);
  int lo, hi;
  hgemm::split_range(split, S, p.ksteps, lo, hi);
  const int steps = hi - lo;
  const int m0 = mt * BM, n0 = nt * BN;
  // B transposed for the slab of k step `step`.
  auto bt = [&](int step) { return bt_base + (step & 1) * BN * LDA; };

  if constexpr (hgemm::Staged<ALoad>::value) {
    al.stage(m0);                         // what the tile's A reads
    __syncthreads();
  }

  typename ALoad::Row rows[A_ITEMS];
#pragma unroll
  for (int i = 0; i < A_ITEMS; ++i)
    rows[i] = al.row(m0 + (tid + i * NT) / (BK / 16));
  typename ALoad::Cursor cur = al.cursor(lo * BK + (tid % (BK / 16)) * 16);

  // Ring slot it % STAGES takes k step lo + it.
  auto load_stage = [&](int it) {
    int8_t* as = ig_smem + (it % STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < A_ITEMS; ++i) {
      const int item = tid + i * NT;
      if (item < BM * (BK / 16))
        al.load(as + (item / (BK / 16)) * LDA + (item % (BK / 16)) * 16,
                rows[i], cur);
    }
    al.advance(cur, BK);
    const int k0 = (lo + it) * KE;
    int8_t* bs = as + A_BYTES;
    if constexpr (TRANS_B) {
      // [n][k] rows of BK bytes, as A's
      const int8_t* const b8 = reinterpret_cast<const int8_t*>(p.B);
#pragma unroll
      for (int item = tid; item < BN * (BK / 16); item += NT) {
        const int nr = item / (BK / 16), c = (item % (BK / 16)) * 16;
        const int n = n0 + nr, kb = k0 * ES + c;
        copy16(bs + nr * LDA + c, b8 + (long long)n * p.ldb * ES + kb,
               n < p.N ? p.K * ES - kb : 0, p.gb, b8);
      }
    } else if constexpr (XPOSE) {
      constexpr int CH = BN / 16;
#pragma unroll
      for (int item = tid; item < BK * CH; item += NT) {
        const int kr = item / CH, c = item % CH;
        const int k = k0 + kr, n = n0 + 16 * c;
        copy16(bs + kr * (BN + PAD) + 16 * (c ^ ((kr >> 2) & 3)),
               p.B + (long long)k * p.ldb + n, k < p.K ? p.N - n : 0,
               p.gb, p.B);
      }
    } else {
      // [k][n] as it lies: KE rows of BN values, 16-byte chunks
      constexpr int CH = BN * ES / 16;
      const int8_t* const b8 = reinterpret_cast<const int8_t*>(p.B);
#pragma unroll
      for (int item = tid; item < KE * CH; item += NT) {
        const int kr = item / CH, c = item % CH;
        const int k = k0 + kr, n = n0 + 16 / ES * c;
        copy16(bs + kr * LDB + 16 * c,
               b8 + ((long long)k * p.ldb + n) * ES,
               k < p.K ? (p.N - n) * ES : 0, p.gb, b8);
      }
    }
  };

  // The bias preloaded into split 0's accumulator (its loads in flight
  // beside the ring's first slabs, not in the epilogue's path).
  // (int16: the A_l B_l accumulator; hh and mid take the other planes.)
  Acc acc[FM][FN][4];
  const Acc* const bias = split == 0 ? p.D : nullptr;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm0 + 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = n0 + wn0 + 8 * j + 2 * (lane & 3) + (e & 1);
        acc[i][j][e] = bias != nullptr && r < p.M && c < p.N
                           ? __ldg(bias + (long long)r * p.ldd + c) : 0;
      }
  int hh[PLANES ? FM : 1][PLANES ? FN : 1][4] = {};   // A_h B_h
  int mid[PLANES ? FM : 1][PLANES ? FN : 1][4] = {};  // A_h B_l + A_l B_h

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    hgemm::cp_async_commit();
  }
  if (XPOSE) {
    hgemm::cp_async_wait<STAGES - 2>();   // slab 0 has landed
    __syncthreads();
    transpose_b<BN, NT>(ig_smem + A_BYTES, bt(lo));
  }
  for (int it = 0; it < steps; ++it) {
    // Slab it landed, and it + 1 where B is transposed a slab ahead; the
    // barrier makes them every thread's, and frees slab it - 1's slot.
    if (XPOSE)
      hgemm::cp_async_wait<STAGES - 3>();
    else
      hgemm::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < steps) load_stage(it + STAGES - 1);
    hgemm::cp_async_commit();
    if (XPOSE && it + 1 < steps)
      transpose_b<BN, NT>(ig_smem + ((it + 1) % STAGES) * STAGE + A_BYTES,
                          bt(lo + it + 1));
    const int8_t* as = ig_smem + (it % STAGES) * STAGE;
    const int8_t* bs = XPOSE ? bt(lo + it) : as + A_BYTES;
    // A and B fragments of the 32-byte k step at kk.
    auto frags = [&](int kk, unsigned (&af)[FM][4], unsigned (&bf)[FN][2]) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldsm_x4(af[i], hgemm::smem_u32(
                           as + (wm0 + 16 * i + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LDA +
                           kk + (lane >> 4) * 16));
#pragma unroll
      for (int j = 0; j < FN; j += 2) {
        unsigned r[4];
        if constexpr (XPOSE || TRANS_B)   // [n][k]
          ldsm_x4(r, hgemm::smem_u32(
                         bs + (wn0 + 8 * j + (lane & 7) + (lane >> 4) * 8) *
                                  LDA +
                         kk + ((lane >> 3) & 1) * 16));
        else                              // [k][n], transposed by the read
          ldsm_x4_trans(r, hgemm::smem_u32(
                               bs + (kk / ES + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * LDB +
                               (wn0 + 8 * j + (lane >> 4) * 8) * ES));
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
    };
    if constexpr (PLANES) {
      // The slab's two 16-k halves as 16-bit fragments (lane quad t: k 2t,
      // 2t + 1 in registers 0 / 1, k 2t + 8, 2t + 9 in 2 / 3 of A and 1 of
      // B), regathered into one m16n8k32 step of each byte plane: A
      // register 2h + r <- half h, row g + 8r; B register h <- half h.
      unsigned af[2][FM][4], bf[2][FN][2];
      frags(0, af[0], bf[0]);
      frags(32, af[1], bf[1]);
      unsigned ah[FM][4], al[FM][4], bh[FN][2], bl[FN][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ah[i][2 * h + r] = hi_bytes(af[h][i][r], af[h][i][r + 2]);
            al[i][2 * h + r] = lo_bytes(af[h][i][r], af[h][i][r + 2]);
          }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          bh[j][h] = hi_bytes(bf[h][j][0], bf[h][j][1]);
          bl[j][h] = lo_bytes(bf[h][j][0], bf[h][j][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          mma_s8<true, true>(hh[i][j], ah[i], bh[j][0], bh[j][1]);
          mma_s8<true, false>(mid[i][j], ah[i], bl[j][0], bl[j][1]);
          mma_s8<false, true>(mid[i][j], al[i], bh[j][0], bh[j][1]);
          mma_s8<false, false>(acc[i][j], al[i], bl[j][0], bl[j][1]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        unsigned af[FM][4], bf[FN][2];
        frags(kk, af, bf);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            if constexpr (INT)
              mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
            else
              hgemm::mma16<In>(acc[i][j], af[i], bf[j][0], bf[j][1]);
          }
      }
    }
  }
  if constexpr (PLANES) {
    // 2^16 hh + 2^8 mid + ll, on unsigned words (wrapping)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = static_cast<int>(
              static_cast<unsigned>(acc[i][j][e]) +
              (static_cast<unsigned>(mid[i][j][e]) << 8) +
              (static_cast<unsigned>(hh[i][j][e]) << 16));
  }
  hgemm::cp_async_wait<0>();

  if (S > 1) {
    // The partial as 4-vectors (int4 / float4), vector i of this thread at
    // i * NT + tid, so a warp's stores and loads are 512 contiguous bytes;
    // the last block of the tile adds the others': int32 sums wrapping, in
    // any order; fp32 sums in split order, its own partial at its place
    // (so a rerun gives the same bits whichever block comes last).
    using V4 = typename hgemm::Vec4<Acc>::type;
    constexpr int F4 = FM * FN;
    const int tile = nt * p.tiles_m + mt;
    const long long stride = (long long)NT * F4 * 4;
    V4* const base = reinterpret_cast<V4*>(
        p.part + (long long)tile * S * stride) + tid;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        base[split * (stride / 4) + (i * FN + j) * NT] =
            V4{acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]};
    if (!last_block(p.tickets + tile, S)) return;
    Acc own[FM][FN][4];    // fp32: this split's partial, added at its place
    if constexpr (!INT) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            own[i][j][e] = acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
    // GP partials' loads in flight at a time (16 vectors a thread), so the
    // merge waits about (S - 1) / GP round trips to L2, not S - 1.
    constexpr int GP = F4 >= 16 ? 1 : 16 / F4;
    for (int s0 = 0; s0 < S; s0 += GP) {
      V4 v[GP][F4];
#pragma unroll
      for (int u = 0; u < GP; ++u)
        if (s0 + u < S && s0 + u != split)
#pragma unroll
          for (int f = 0; f < F4; ++f)
            v[u][f] = __ldcg(base + (s0 + u) * (stride / 4) + f * NT);
#pragma unroll
      for (int u = 0; u < GP; ++u)
        if (s0 + u < S && (!INT || s0 + u != split))
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j) {
              V4 w = v[u][i * FN + j];
              if constexpr (!INT)
                if (s0 + u == split)
                  w = V4{own[i][j][0], own[i][j][1], own[i][j][2],
                         own[i][j][3]};
              acc[i][j][0] = hgemm::add(acc[i][j][0], w.x);
              acc[i][j][1] = hgemm::add(acc[i][j][1], w.y);
              acc[i][j][2] = hgemm::add(acc[i][j][2], w.z);
              acc[i][j][3] = hgemm::add(acc[i][j][3], w.w);
            }
    }
  }

  // The epilogue: the tile through shared memory (the ring is free), then
  // one compact loop of 16-byte stores, consecutive threads on consecutive
  // columns.
  __syncthreads();
  using V2 = std::conditional_t<INT, int2, float2>;
  Acc* ct = reinterpret_cast<Acc*>(ig_smem);  // [BM][LDC]
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        Acc* c0 = ct + (wm0 + 16 * i + g) * LDC + wn0 + 8 * j + 2 * t;
        *reinterpret_cast<V2*>(c0) = V2{acc[i][j][0], acc[i][j][1]};
        *reinterpret_cast<V2*>(c0 + 8 * LDC) = V2{acc[i][j][2], acc[i][j][3]};
      }
  }
  __syncthreads();
  // outputs per 16-byte store
  const int G = p.out == OUT_8 ? 16 : p.out == OUT_32 ? 4 : 8;
  const int per_row = BN / G;
#pragma unroll 1
  for (int e = tid; e < BM * per_row; e += NT) {
    const int r = e / per_row, c = (e % per_row) * G;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= p.M || gc >= p.N) continue;
    const Acc* src = ct + r * LDC + c;
    const long long at = (long long)gr * p.N + gc;
    const bool whole = p.vec_c && gc + G <= p.N;
    if constexpr (!INT) {
      auto y = [&](float v) { return epi::activate(v, p.act) * p.out_scale; };
      if (p.out == OUT_32)
        store_run(static_cast<float*>(p.C) + at, src, p.N - gc, whole, y);
      else if (p.out == OUT_BF16)
        store_run(static_cast<__nv_bfloat16*>(p.C) + at, src, p.N - gc,
                  whole, [&](float v) { return epi::to<__nv_bfloat16>(y(v)); });
      else
        store_run(static_cast<__half*>(p.C) + at, src, p.N - gc, whole,
                  [&](float v) { return epi::to<__half>(y(v)); });
    } else if (p.out == OUT_8) {
      unsigned w[4] = {0, 0, 0, 0};
      int8_t* C = static_cast<int8_t*>(p.C) + at;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int y = min(max(finish(src[q], p.shift, p.act), -128), 127);
        w[q >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(y))
                     << (8 * (q & 3));
        if (!whole && gc + q < p.N) C[q] = static_cast<int8_t>(y);
      }
      if (whole)
        *reinterpret_cast<uint4*>(C) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (p.out == OUT_16) {
      store_run(static_cast<int16_t*>(p.C) + at, src, p.N - gc, whole,
                [&](int v) {
                  return static_cast<int16_t>(
                      min(max(finish(v, p.shift, p.act), -32768), 32767));
                });
    } else {
      store_run(static_cast<int*>(p.C) + at, src, p.N - gc, whole,
                [&](int v) { return finish(v, p.shift, p.act); });
    }
  }
}

template <typename In, int R, bool TB, typename ALoad>
cudaError_t launch_regime(const Args<In>& a, const ALoad& al, const Plan& pl,
                          cudaStream_t s) {
  auto kern = kernel<In, R, TB, ALoad>;
  static int configured = 0;  // largest dynamic shared memory allowed yet
  if (pl.smem > 48 * 1024 && pl.smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return e;
    configured = pl.smem;
  }
  kern<<<(unsigned)pl.blocks, pl.threads, pl.smem, s>>>(a, al);
  return cudaGetLastError();
}

template <typename In, bool TB, typename ALoad>
cudaError_t launch_plan(const Args<In>& a, const ALoad& al, const Plan& pl,
                        cudaStream_t s) {
  if (pl.regime == SKINNY) return launch_regime<In, SKINNY, TB>(a, al, pl, s);
  return launch_regime<In, SQUARE, TB>(a, al, pl, s);
}

// The plan of a call with K values of es bytes.
inline Plan plan_here(int m, int n, int k, int b_trans, int es = 1) {
  return plan(m, n, k * es, b_trans, hgemm::sm_count(), es);
}

// The same, or the caller's (tile, splits) where they are not 0, 0;
// false where the kernel cannot run the caller's.
inline bool resolve_here(int m, int n, int k, int b_trans, int es, int tile,
                         int splits, Plan& p) {
  if (tile == 0 && splits == 0) {
    p = plan_here(m, n, k, b_trans, es);
    return true;
  }
  return plan_with(m, n, k * es, b_trans, es, tile, splits, p);
}

// One call: A through `al` (its k counted in bytes), B (K, N) at ldb
// (b_trans: the transpose of a row-major (N, K) buffer), D, C,
// `out` (OUT_*) as Args says, out_scale 2^-shift for 16-bit inputs;
// workspace: plan().ws_words 4-byte words owned by the calling stream
// (tickets zeroed when it was made), may be null for one split;
// extra_smem: bytes a staging loader takes after the plan's shared memory;
// tile, splits: the caller's plan (plan_with), or 0, 0 for the call's own.
// TRANS_B_OK: whether this source instantiates the (N, K) path (the
// conv's filters are never transposed).
template <typename In, typename ALoad, bool TRANS_B_OK = true>
cudaError_t launch(const ALoad& al, const In* B, long long ldb, int b_trans,
                   const typename Dp<In>::Acc* D, long long ldd, void* C,
                   int out, int M, int N, int K, int shift, float out_scale,
                   int act, int ws, void* workspace, cudaStream_t s,
                   int extra_smem = 0, int tile = 0, int splits = 0) {
  using Acc = typename Dp<In>::Acc;
  constexpr int ES = (int)sizeof(In);
  Plan pl;
  if (!resolve_here(M, N, K, b_trans, ES, tile, splits, pl))
    return cudaErrorInvalidValue;
  pl.smem += extra_smem;
  if (pl.splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  Args<In> a{};
  a.B = B; a.ldb = ldb; a.gb = granule(B, ldb * ES);
  a.D = D; a.ldd = ldd;
  a.C = C; a.out = out;
  a.vec_c = reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
            N % (out == OUT_8 ? 16 : out == OUT_32 ? 4 : 8) == 0;
  a.M = M; a.N = N; a.K = K; a.shift = shift; a.act = act;
  a.out_scale = out_scale;
  a.tiles_m = pl.tiles_m; a.tiles_n = pl.tiles_n;
  a.ksteps = pl.ksteps; a.splits = pl.splits;
  a.ws = ws;
  a.tickets = static_cast<int*>(workspace);
  a.part = workspace ? reinterpret_cast<Acc*>(static_cast<int*>(workspace) +
                                              hgemm::MAX_TICKETS)
                     : nullptr;
  if constexpr (TRANS_B_OK) {
    if (b_trans) return launch_plan<In, true>(a, al, pl, s);
  } else {
    if (b_trans) return cudaErrorInvalidValue;
  }
  return launch_plan<In, false>(a, al, pl, s);
}

}  // namespace igemm
