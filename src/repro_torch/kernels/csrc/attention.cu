// Attention kernels for Hopper: flash (fresh prompt), paged prefill
// (continuation chunk), paged decode (one token per slot) and dense decode
// (one token against a contiguous cache, the static reference path).
//
// Replaces, in src/repro/kernels/attention.py, and the kernel each entry
// point reaches per dtype:
//   flash_attention          (_attn_kernel)          bf16 / fp16 -> flash_tc_kernel<D, DenseKV, T>
//                                                    fp32 -> flash_f32_kernel<D, DenseKV32>
//   paged_prefill_attention  (_paged_prefill_kernel) bf16 / fp16 -> flash_tc_kernel<D, PagedKV, T>
//                                                    fp32 -> flash_f32_kernel<D, PagedKV32>
//   paged_decode_attention   (_paged_decode_kernel)  all -> decode_split_kernel<D, T, REP, PagedDecodeKV>
//   decode_attention         (_decode_kernel)        all -> decode_split_kernel<D, T, REP, DenseDecodeKV>
//
// All compute the TPU kernels' online softmax with fp32 statistics: scores
// of the scaled query against each key, optional softcap, the causal /
// window / length masks with the -0.7 * FLT_MAX mask constant (a -inf
// would turn a fully masked row into exp(-inf - -inf) = NaN), the running
// (m, l, acc) update, and the finalize acc / max(l, 1e-37). On the TPU the
// KV axis is a sequential grid dimension carrying (m, l, acc) in scratch;
// here it is split over warps (and blocks), each carrying its own partial
// state, and the partials are merged in a fixed order, so a result is the
// same bit for bit from run to run.
//
// What bounds them on the H100, and what each design does about it:
//  * flash_tc_kernel (bf16 flash): at serving shapes neither bytes nor
//    operations but latency -- a 256-token prompt is ~0.1 GFLOP over ~1 MB.
//    So the grid is made wide and each warp's chain short. A block owns 16
//    query rows of one head (one m16 MMA tile); its 4 warps, and the 1-4
//    blocks of its thread-block cluster, split that tile's live key range
//    between them in 16-64-key tiles, round robin (which also evens out the
//    causal imbalance between early and late query tiles). Each warp
//    streams its K/V tiles global -> shared with 16-byte cp.async, double
//    buffered where it has more than one tile (else one stage, so more
//    blocks fit on an SM), into rows padded by 16 bytes so ldmatrix is
//    free of bank conflicts; Q stays in registers as bf16 A fragments.
//    S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 out; the products
//    of bf16 inputs are exact) and the scale is applied to the fp32
//    scores. P stays fp32 as in the TPU kernel: it is split as P = P_hi +
//    P_lo, two bf16 fragments, and both go through the P V MMA into one
//    fp32 accumulator (~16 mantissa bits). Row max and sum reduce over the
//    fragment's lane quad. The warps' (m, l, acc) partials merge in shared
//    memory, then the cluster's block partials over distributed shared
//    memory, each block finalizing a slice of the head dim. K/V
//    addressing is a loader policy: DenseKV for flash; PagedKV for bf16
//    paged prefill (one request's chunk at [start, start + T): queries
//    offset by start, keys [0, start + T) through the block table), which
//    finds each key row's page once per row of a tile -- lanes look up
//    their rows, the 16-byte chunks take the row by shuffle -- so pages
//    smaller than a key tile cost nothing more.
//  * flash_f32_kernel (fp32 flash, fp32 paged prefill): IEEE fp32 on the
//    CUDA cores (the tensor cores offer no fp32; tf32-split products did
//    not pay in the fp32 SSD). Bound by operations at hymba-1.5b's 256-row
//    chunk (4 D pairs FLOP at 67 TFLOP/s), by latency at the gate's small
//    ones. flash_tc_kernel's plan carried to the CUDA cores: a block owns
//    RB = 8-32 rows (by D) of one kv head's (position, query head) pairs,
//    position-major, so every K/V tile is read once per GQA group, not
//    once per query head; its 4 warps, and the 1-4 blocks of its cluster
//    where the grid is short of the SMs, split the live 16-key tiles
//    round robin; each warp streams its K/V tiles by 16-byte cp.async,
//    double buffered where it has more than one (paged rows find their
//    page once per row, as PagedKV does). Scores and P V are register
//    micro-tiles from shared memory by 16-byte reads (a lane: RPL rows x 4
//    keys, then RPL rows x D / 4 channels; P through the warp's shared
//    tile), every product an fmaf. The row max and sum reduce over a lane
//    quad. Row tiles go latest first (causal rows see the most keys), dead
//    key tiles are skipped (block_live), and the warps' and the cluster's
//    partials merge as flash_tc_kernel's do, in a fixed order.
//  * decode_split_kernel (dense and paged decode): bytes, and at a few
//    sequences, latency. One query per head reads every live K/V row once;
//    a block handles the query heads of its kv head together (up to 8), so
//    K/V are read once per kv head (GQA). The live keys [max(0, pos -
//    window + 1), min(pos + 1, reach)) go in splits of DS_SPLIT = 64 keys,
//    one block each, with 16-byte vector loads; each block writes its
//    partial (m, l, acc) to a workspace, and the last block of a
//    (sequence, kv head, head group) to finish -- found by an atomic ticket
//    -- merges the splits in a fixed order, in the same launch (a single
//    split finalizes in place), and sets the ticket back to 0, so no
//    launch needs a memset. Keys before the window or past the length are
//    never read. The key range and row addressing are a loader policy, as
//    flash's are (DenseKV): DenseDecodeKV takes the range from the host's
//    pos and the host plans exactly the live splits; PagedDecodeKV takes
//    it from the slot's length in device memory and finds each row's page
//    through the block table, and its grid comes from the shapes alone --
//    the splits the table's reach (or the window) can hold -- with each
//    block working out from the length whether its split is live; a dead
//    one returns at once. So a paged decode step is one launch whose grid
//    and arguments do not change with the lengths (it can be captured in
//    a CUDA graph). Paged splits start on multiples of 64 keys, so at page
//    64 a split is one page.
//
// Head dims 16, 32, 64, 128 and 256 are compiled; inputs are fp32, bf16 or
// fp16 (accumulation is always fp32, output in the input type, as the TPU
// kernels upcast every operand to fp32 and write q's dtype).
//
// fp16 on the tensor cores (flash_tc_kernel<D, Loader, __half>): the same
// fragments, ldmatrix and plan as bf16, the MMA's .f16 variant. Q and K
// are fp16 already (exact products, fp32 sums). P is fp32 and its split
// into two MMA operands of V's type is where fp16's narrow range could
// bite; the design scales per row: P = exp(s - m) with m the row's running
// maximum, so P <= 1 can never overflow fp16, and P = P_hi + P_lo in fp16
// keeps ~22 bits for P >= 2^-14. Only terms with P < 2^-25 flush to zero
// (fp16's subnormals end at 2^-24), each at most 2^-25 of its |V| against
// an output that the row's maximum key (P = 1) and l >= 1 hold at fp16's
// 2^-11 resolution: a 2048-key row of such terms moves the output by under
// 2^-14 of the largest |V|, within the fp16 rule (phase 3 holds a row
// whose softmax spans more than 20 decades). The decode kernels read fp16
// K/V on the CUDA cores, converted to fp32 as bf16 is.
//
// C interface: flash_attention_launch, paged_prefill_launch,
// paged_decode_launch, decode_attention_launch (each returns
// cudaGetLastError()), and flash_attention_plan, paged_prefill_plan,
// decode_attention_plan / paged_decode_plan, which report the geometry a
// flash or paged prefill call, or the grid and the workspace a decode
// call, will use. Dense flash and
// paged decode take an optional plan, the tuner's: a flash call's blocks
// per cluster and stages, a paged decode call's keys per split (0s: the
// plan of the shape).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr float NEG = -0.7f * FLT_MAX;
constexpr unsigned FULL = 0xffffffffu;
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void st(__half* p, float v) {
  *p = __float2half_rn(v);
}

// A 16-bit element type's pair: its vector type, to and from two floats
// (round to nearest even; fp16 past its range reads +-inf).
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 f2(type h) {
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ type make(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ float2 f2(type h) {
    return __half22float2(h);
  }
  static __device__ __forceinline__ type make(float x, float y) {
    return __floats2half2_rn(x, y);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// N contiguous elements of T to fp32 registers, in one vector load where
// the width allows (callers guarantee the alignment).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  if constexpr (sizeof(T) == 2 && N == 8) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const auto* h = reinterpret_cast<const typename Pair<T>::type*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = Pair<T>::f2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (sizeof(T) == 4 && N == 4) {
    float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = ld(p + i);
  }
}


// ---------------------------------------------------------------------------
// flash_attention, bf16: tensor cores, a 16-row query tile per block, keys
// split over the block's warps and its cluster's blocks.
// ---------------------------------------------------------------------------
constexpr int FT_WARPS = 4;           // key splitters per block
constexpr int FT_ROWS = 16;           // query rows per block (one m16 tile)
constexpr int FT_MAX_CLUSTER = 4;     // blocks per cluster (a power of two)

// Per head dim: keys per warp tile and the padded shared-memory row (16
// bytes past D, so the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups). A warp owns one or two stages of (K, V) tiles -- two only
// where some warp has more than one tile to stream, since shared memory
// decides how many blocks share an SM; after its loop the same bytes hold
// its partial (m[16], l[16], acc[16][D]) in fp32.
template <int D>
struct FlashTile {
  static constexpr int KT = D >= 256 ? 16 : D >= 128 ? 32 : 64;
  static constexpr int LD = D + 8;
  static constexpr int STAGE = 2 * KT * LD;                 // elements
  static constexpr int STAGE_BYTES = STAGE * (int)sizeof(bf16);
  static constexpr int MERGE_FLOATS = (FT_WARPS + 2) * FT_ROWS;
  static constexpr int smem(int stages) {
    return FT_WARPS * stages * STAGE_BYTES + MERGE_FLOATS * 4;
  }
  static_assert(STAGE_BYTES >= (32 + FT_ROWS * D) * 4, "partial must fit");
};

struct FlashArgs {
  const bf16* q;       // (B, Tq, H, D) contiguous
  const bf16* k;       // dense: (B, Tk, KVH, D); paged: pool (KVH, NPOOL, PAGE, D)
  const bf16* v;
  bf16* o;             // (B, Tq, H, D)
  const int* table;    // paged: logical page -> pool page (B = 1)
  int Tq, Tk, H, KVH;
  int q_offset;        // position of query row 0 (Tk - Tq: right-aligned)
  int causal, window;  // window 0 = global
  int npool, page;     // paged geometry
  int stages;          // K/V stages per warp: 1 or 2
  float softcap;       // 0 = none
  float scale;
};

// The K/V loader policy: where key row kpos of (sequence b, kv head kvh)
// lives. row(kpos) names the row (one lookup per key row of a tile, only
// for keys below Tk); k_row / v_row turn a name into its address, and
// name 0 is always a valid address (the zero-filled slots point there).
// Dense rows are strided: the name is the position.
struct DenseKV {
  const bf16* k;
  const bf16* v;
  long long stride;    // elements between consecutive keys
  __device__ DenseKV(const FlashArgs& p, int b, int kvh, int D)
      : stride((long long)p.KVH * D) {
    const long long base = (long long)b * p.Tk * stride + (long long)kvh * D;
    k = p.k + base;
    v = p.v + base;
  }
  __device__ int row(int kpos) const { return kpos; }
  __device__ const bf16* k_row(int r) const { return k + r * stride; }
  __device__ const bf16* v_row(int r) const { return v + r * stride; }
};

// Paged (one request, B = 1): the name is the row's place in the kv head's
// pool, page * PAGE + offset, from the request's block table.
struct PagedKV {
  const bf16* k;
  const bf16* v;
  const int* table;
  int page, dim;
  __device__ PagedKV(const FlashArgs& p, int, int kvh, int D)
      : table(p.table), page(p.page), dim(D) {
    const long long base = (long long)kvh * p.npool * p.page * D;
    k = p.k + base;
    v = p.v + base;
  }
  __device__ int row(int kpos) const {
    return __ldg(table + kpos / page) * page + kpos % page;
  }
  __device__ const bf16* k_row(int r) const { return k + (long long)r * dim; }
  __device__ const bf16* v_row(int r) const { return v + (long long)r * dim; }
};

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
// c += a (16x16, row) * b (16x8, col); T (bf16 or fp16) in, fp32
// accumulate: the same fragments, the instruction's type differs.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <typename P2>
__device__ __forceinline__ uint32_t bits(P2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) as a T pair hi plus the pair of what rounding left, lo.
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const auto h = Pair<T>::make(x, y);
  const float2 hf = Pair<T>::f2(h);
  hi = bits(h);
  lo = bits(Pair<T>::make(x - hf.x, y - hf.y));
}

// Live keys [lo, hi) of the 16-row query tile whose first row sits at
// position q0 (the TPU kernels' block_live rule, per tile).
__host__ __device__ __forceinline__ void flash_tile_keys(
    int q0, int Tk, int causal, int window, int& lo, int& hi) {
  lo = window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1 : 0) : 0;
  hi = Tk;
  if (causal && q0 + FT_ROWS < hi) hi = q0 + FT_ROWS;
}

template <int D, typename Loader, typename T>
__global__ void __launch_bounds__(FT_WARPS * 32, 1)
flash_tc_kernel(FlashArgs p) {
  using Tl = FlashTile<D>;
  constexpr int KT = Tl::KT, LD = Tl::LD, KS = D / 16, NT = KT / 8,
                ND = D / 8;
  extern __shared__ __align__(16) unsigned char fsm[];
  const int warp_bytes = p.stages * Tl::STAGE_BYTES;
  float* fac = reinterpret_cast<float*>(fsm + FT_WARPS * warp_bytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;      // fragment row, column pair
  const int row0 = blockIdx.y * FT_ROWS;
  const int h = blockIdx.z % p.H, b = blockIdx.z / p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = p.q_offset + row0;
  const Loader kv(p, b, kvh, D);
  bf16* stage0 = reinterpret_cast<bf16*>(fsm + warp * warp_bytes);

  // Q as A fragments: rows g and g + 8, columns 2 qd (+1) and + 8.
  uint32_t qf[KS][4];
  {
    const bool ok_a = row0 + g < p.Tq, ok_b = row0 + g + 8 < p.Tq;
    const bf16* qa = p.q + (((long long)b * p.Tq + row0 + g) * p.H + h) * D;
    const bf16* qb = qa + 8LL * p.H * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * qd;
      qf[ks][0] = ok_a ? *reinterpret_cast<const uint32_t*>(qa + c) : 0u;
      qf[ks][1] = ok_b ? *reinterpret_cast<const uint32_t*>(qb + c) : 0u;
      qf[ks][2] = ok_a ? *reinterpret_cast<const uint32_t*>(qa + c + 8) : 0u;
      qf[ks][3] = ok_b ? *reinterpret_cast<const uint32_t*>(qb + c + 8) : 0u;
    }
  }

  int k_lo, k_hi;
  flash_tile_keys(q0, p.Tk, p.causal, p.window, k_lo, k_hi);
  const int t_end = k_hi > k_lo ? (k_hi + KT - 1) / KT : 0;
  const int n_split = CL * FT_WARPS;

  // Lane j names the tile's rows j and j + 32 (one lookup each); the lanes
  // copying a row's 16-byte chunks take its name by shuffle. Keys no row
  // of the tile can see -- at or past Tk, or before the window's first --
  // are never looked up or read: their slots are zero-filled (and masked).
  constexpr int RPL = (KT + 31) / 32;
  auto load_tile = [&](int t, int stage) {
    bf16* ks = stage0 + stage * Tl::STAGE;
    bf16* vs = ks + KT * LD;
    int names[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int r = lane + 32 * i, kpos = t * KT + r;
      names[i] = r < KT && kpos >= k_lo && kpos < k_hi ? kv.row(kpos) : 0;
    }
#pragma unroll
    for (int c = lane; c < KT * D / 8; c += 32) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int kpos = t * KT + r;
      const bool ok = kpos >= k_lo && kpos < k_hi;
      int name = __shfl_sync(FULL, names[0], r & 31);
      if constexpr (RPL > 1) {
        const int hi = __shfl_sync(FULL, names[RPL - 1], r & 31);
        if (r >= 32) name = hi;
      }
      cp_async16(ks + r * LD + col, kv.k_row(name) + col, ok);
      cp_async16(vs + r * LD + col, kv.v_row(name) + col, ok);
    }
  };

  float acc[ND][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int t = k_lo / KT + rank * FT_WARPS + warp, stage = 0;
  if (t < t_end) load_tile(t, 0);
  cp_async_commit();
  for (; t < t_end; t += n_split) {
    const int next = t + n_split;
    if (p.stages == 2 && next < t_end) load_tile(next, stage ^ 1);
    cp_async_commit();
    if (p.stages == 2) cp_async_wait<1>();  // tile t has landed
    else cp_async_wait<0>();
    __syncwarp();
    const bf16* ks = stage0 + stage * Tl::STAGE;
    const bf16* vs = ks + KT * LD;

    // S = Q K^T: B fragments of two 8-key tiles per ldmatrix.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(s[j], qf[kk], r[0], r[1]);
        mma16<T>(s[j + 1], qf[kk], r[2], r[3]);
      }
    }

    // Scale, softcap and mask the fp32 scores; online softmax per row.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = t * KT + j * 8 + 2 * qd + (e & 1);
        const int qpos = q0 + g + 8 * (e >> 1);
        float x = s[j][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Tk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[j][e] = ok ? x : NEG;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      corr[r] = expf(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - mx);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;        // this lane's share of the row
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // acc += P V with P = P_hi + P_lo; V's B fragments by ldmatrix.trans.
#pragma unroll
    for (int kb = 0; kb < KT / 16; ++kb) {
      uint32_t ph[4], pl[4];
      split_pair<T>(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
      split_pair<T>(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
      split_pair<T>(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
      split_pair<T>(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         n * 8 + (lane >> 4) * 8);
        mma16<T>(acc[n], ph, r[0], r[1]);
        mma16<T>(acc[n], pl, r[0], r[1]);
        mma16<T>(acc[n + 1], ph, r[2], r[3]);
        mma16<T>(acc[n + 1], pl, r[2], r[3]);
      }
    }
    __syncwarp();                         // stage is free for the next load
    if (p.stages == 2) stage ^= 1;
    else if (next < t_end) load_tile(next, 0);
  }
  cp_async_wait<0>();
  __syncwarp();

  // This warp's partial over its tiles: (m, l, acc) rows g and g + 8. A
  // warp that saw no live key of a row holds m = NEG there and weighs 0.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  float* part = reinterpret_cast<float*>(stage0);
  if (qd == 0) {
    part[g] = m[0]; part[g + 8] = m[1];
    part[16 + g] = l[0]; part[16 + g + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * qd;
    *reinterpret_cast<float2*>(part + 32 + g * D + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part + 32 + (g + 8) * D + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();

  // Merge the block's warps in warp order into warp 0's partial, in
  // place: each element is read and written by one thread.
  auto warp_part = [&](int w) {
    return reinterpret_cast<float*>(fsm + w * warp_bytes);
  };
  if (threadIdx.x < FT_ROWS) {
    const int row = threadIdx.x;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < FT_WARPS; ++w) mm = fmaxf(mm, warp_part(w)[row]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < FT_WARPS; ++w) {
      const float f = expf(warp_part(w)[row] - mm);
      fac[w * FT_ROWS + row] = f;
      ls += warp_part(w)[16 + row] * f;
    }
    fac[FT_WARPS * FT_ROWS + row] = mm;
    fac[(FT_WARPS + 1) * FT_ROWS + row] = ls;
  }
  __syncthreads();
  float* blk = warp_part(0);
  for (int e = threadIdx.x * 4; e < FT_ROWS * D; e += FT_WARPS * 32 * 4) {
    const int row = e / D;
    float4 a = *reinterpret_cast<const float4*>(blk + 32 + e);
    const float f0 = fac[row];
    a.x *= f0; a.y *= f0; a.z *= f0; a.w *= f0;
#pragma unroll
    for (int w = 1; w < FT_WARPS; ++w) {
      const float4 b = *reinterpret_cast<const float4*>(warp_part(w) + 32 + e);
      const float f = fac[w * FT_ROWS + row];
      a.x += b.x * f; a.y += b.y * f; a.z += b.z * f; a.w += b.w * f;
    }
    *reinterpret_cast<float4*>(blk + 32 + e) = a;
  }
  if (threadIdx.x < FT_ROWS) {
    blk[threadIdx.x] = fac[FT_WARPS * FT_ROWS + threadIdx.x];
    blk[16 + threadIdx.x] = fac[(FT_WARPS + 1) * FT_ROWS + threadIdx.x];
  }
  cluster.sync();

  // Merge the cluster's block partials in rank order over distributed
  // shared memory; block `rank` finalizes the columns [rank * D / CL,
  // (rank + 1) * D / CL), four at a time, with every remote load of an
  // item issued before any is used.
  const int cols = D / CL, c0 = rank * cols;
  for (int e = threadIdx.x; e < FT_ROWS * cols / 4; e += FT_WARPS * 32) {
    const int row = e / (cols / 4), c = c0 + (e % (cols / 4)) * 4;
    float mb[FT_MAX_CLUSTER], lb[FT_MAX_CLUSTER];
    float4 ab[FT_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < FT_MAX_CLUSTER; ++r) {
      if (r < CL) {
        const float* pr = cluster.map_shared_rank(blk, r);
        mb[r] = pr[row];
        lb[r] = pr[16 + row];
        ab[r] = *reinterpret_cast<const float4*>(pr + 32 + row * D + c);
      }
    }
    if (row0 + row >= p.Tq) continue;
    float mm = NEG;
#pragma unroll
    for (int r = 0; r < FT_MAX_CLUSTER; ++r)
      if (r < CL) mm = fmaxf(mm, mb[r]);
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < FT_MAX_CLUSTER; ++r) {
      if (r < CL) {
        const float f = expf(mb[r] - mm);
        ls += lb[r] * f;
        o.x += ab[r].x * f; o.y += ab[r].y * f;
        o.z += ab[r].z * f; o.w += ab[r].w * f;
      }
    }
    ls = fmaxf(ls, 1e-37f);
    bf16* out = p.o + (((long long)b * p.Tq + row0 + row) * p.H + h) * D + c;
    using T2 = typename Pair<T>::type;
    reinterpret_cast<T2*>(out)[0] = Pair<T>::make(o.x / ls, o.y / ls);
    reinterpret_cast<T2*>(out)[1] = Pair<T>::make(o.z / ls, o.w / ls);
  }
  cluster.sync();                         // peers stop reading our partials
}

// Blocks per cluster: enough key splitters that the busiest query tile's
// key tiles go one to a warp, at most FT_MAX_CLUSTER, a power of two; and
// the stages a warp needs (two where it streams more than one tile).
template <int D>
int flash_cluster(const FlashArgs& a, int& stages) {
  constexpr int KT = FlashTile<D>::KT;
  int most = 0;
  for (int row0 = 0; row0 < a.Tq; row0 += FT_ROWS) {
    int lo, hi;
    flash_tile_keys(a.q_offset + row0, a.Tk, a.causal, a.window, lo, hi);
    if (hi > lo) {
      const int n = (hi + KT - 1) / KT - lo / KT;
      most = n > most ? n : most;
    }
  }
  int cl = 1;
  while (cl < FT_MAX_CLUSTER && cl * FT_WARPS < most) cl *= 2;
  stages = most > cl * FT_WARPS ? 2 : 1;
  return cl;
}

// A caller's (cluster, stages): 0, 0 for the call's own; else blocks per
// cluster a power of two up to `most`, stages 1 up to `stages_most`.
inline bool flash_override(int cluster, int stages, int most,
                           int stages_most) {
  return cluster >= 1 && cluster <= most && (cluster & (cluster - 1)) == 0 &&
         stages >= 1 && stages <= stages_most;
}

// A flash launch's geometry: blocks per cluster, K/V stages a warp, the
// grid, threads per block and dynamic shared memory.
struct FlashGeom {
  int cluster, stages;
  dim3 grid;
  int threads, smem;
};

// The bf16 kernel's geometry for a call with the caller's (cluster,
// stages), 0, 0 for its own; false where the kernel cannot run the
// caller's.
template <int D>
bool flash_tc_geom(const FlashArgs& a, int batch, int cluster, int stages,
                   FlashGeom& g) {
  if (cluster == 0 && stages == 0) {
    g.cluster = flash_cluster<D>(a, g.stages);
  } else {
    if (!flash_override(cluster, stages, FT_MAX_CLUSTER, 2)) return false;
    g.cluster = cluster;
    g.stages = stages;
  }
  g.grid = dim3(g.cluster, (a.Tq + FT_ROWS - 1) / FT_ROWS, a.H * batch);
  g.threads = FT_WARPS * 32;
  g.smem = FlashTile<D>::smem(g.stages);
  return true;
}

template <int D, typename Loader, typename T>
cudaError_t launch_flash_tc(FlashArgs a, int batch, int cluster, int stages,
                            cudaStream_t s) {
  FlashGeom g;
  if (!flash_tc_geom<D>(a, batch, cluster, stages, g))
    return cudaErrorInvalidValue;
  a.stages = g.stages;
  const int cl = g.cluster;
  const dim3 grid = g.grid;
  auto kernel = flash_tc_kernel<D, Loader, T>;
  static bool configured = false;     // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FlashTile<D>::smem(2));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename Loader, typename T>
cudaError_t flash_tc_by_dim(int D, const FlashArgs& a, int batch, int cluster,
                            int stages, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_flash_tc<16, Loader, T>(a, batch, cluster, stages, s);
    case 32:
      return launch_flash_tc<32, Loader, T>(a, batch, cluster, stages, s);
    case 64:
      return launch_flash_tc<64, Loader, T>(a, batch, cluster, stages, s);
    case 128:
      return launch_flash_tc<128, Loader, T>(a, batch, cluster, stages, s);
    case 256:
      return launch_flash_tc<256, Loader, T>(a, batch, cluster, stages, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 or fp16 (the 16-bit dtype code) on the tensor-core kernel.
template <typename Loader>
cudaError_t flash_tc_dispatch(int dtype, int D, const FlashArgs& a, int batch,
                              int cluster, int stages, cudaStream_t s) {
  return dtype == DT_F16
             ? flash_tc_by_dim<Loader, __half>(D, a, batch, cluster, stages, s)
             : flash_tc_by_dim<Loader, bf16>(D, a, batch, cluster, stages, s);
}

// ---------------------------------------------------------------------------
// flash_attention and paged_prefill_attention, fp32: CUDA cores (IEEE fp32
// FMAs), a block per row tile of one kv head's query heads, key tiles split
// over its warps and its cluster's blocks.
// ---------------------------------------------------------------------------
constexpr int F32_WARPS = 4;          // key splitters per block
constexpr int F32_KT = 16;            // keys per tile
constexpr int F32_KPL = F32_KT / 4;   // keys a lane
static_assert(F32_KT % 4 == 0 && F32_KT <= 32, "a lane names a tile row");
constexpr int F32_MAX_CLUSTER = 4;    // blocks per cluster (a power of two)

// Per head dim: a lane's rows (RPL; the block's RB = 8 RPL rows keep a
// lane's accumulators at RPL x D / 4 <= 64 floats), the padded shared rows
// (4 floats past D or past the tile's keys: the 8 rows a quarter warp
// reads by 16-byte vectors fall in 8 distinct bank quads), a stage of K
// and V tiles, and the block's shared memory: Q, each warp's P tile, the
// merge's factors, then each warp's ring of stages, whose first stage
// holds its partial (m[RB], l[RB], acc[RB][D]) after the loop.
template <int D>
struct F32Tile {
  static constexpr int RPL = D <= 64 ? 4 : D == 128 ? 2 : 1;
  static constexpr int RB = 8 * RPL;
  static constexpr int LD = D + 4;
  static constexpr int LDP = F32_KT + 4;
  static constexpr int STAGE = 2 * F32_KT * LD;             // floats
  static constexpr int MAX_STAGES = D >= 256 ? 1 : 2;
  static constexpr int HEAD = RB * LD + F32_WARPS * RB * LDP +
                              (F32_WARPS + 2) * RB;         // floats
  static constexpr int smem(int stages) {
    return 4 * (HEAD + F32_WARPS * stages * STAGE);
  }
  static_assert(STAGE >= 2 * RB + RB * D, "partial must fit a stage");
  static_assert(HEAD % 4 == 0 && D % 16 == 0, "16-byte rows");
};

struct F32Args {
  const float* q;      // (B, Tq, H, D) contiguous
  const float* k;      // dense: (B, Tk, KVH, D); paged: pool (KVH, NPOOL, PAGE, D)
  const float* v;
  float* o;            // (B, Tq, H, D)
  const int* table;    // paged: logical page -> pool page (B = 1)
  int Tq, H, KVH;
  int q_offset;        // position of query row 0
  int kv_len;          // live keys are [0, kv_len)
  int causal, window;  // window 0 = global
  int npool, page;     // paged geometry
  int stages;          // K/V stages per warp: 1 or 2
  float softcap;       // 0 = none
  float scale;
};

// The fp32 kernel's K/V loaders, as DenseKV / PagedKV: row(kpos) names key
// row kpos (one lookup per row of a tile), k_row / v_row its address; name
// 0 is always a valid address.
struct DenseKV32 {
  const float* k;
  const float* v;
  long long stride;    // elements between consecutive keys
  __device__ DenseKV32(const F32Args& p, int b, int kvh, int D)
      : stride((long long)p.KVH * D) {
    const long long base = (long long)b * p.kv_len * stride + (long long)kvh * D;
    k = p.k + base;
    v = p.v + base;
  }
  __device__ int row(int kpos) const { return kpos; }
  __device__ const float* k_row(int r) const { return k + r * stride; }
  __device__ const float* v_row(int r) const { return v + r * stride; }
};

struct PagedKV32 {
  const float* k;
  const float* v;
  const int* table;
  int page, dim;
  __device__ PagedKV32(const F32Args& p, int, int kvh, int D)
      : table(p.table), page(p.page), dim(D) {
    const long long base = (long long)kvh * p.npool * p.page * D;
    k = p.k + base;
    v = p.v + base;
  }
  __device__ int row(int kpos) const {
    return __ldg(table + kpos / page) * page + kpos % page;
  }
  __device__ const float* k_row(int r) const { return k + (long long)r * dim; }
  __device__ const float* v_row(int r) const { return v + (long long)r * dim; }
};

// Rows of a block: row r is the pair (position, query head) number rb0 + r
// of the kv head's Tq x G pairs, position-major, so a block's rows share
// few positions and one K/V tile serves them all. Live keys [lo, hi) of
// the rows [rb0, rb0 + RB) (the TPU kernels' block_live rule, per block).
__host__ __device__ __forceinline__ void f32_block_keys(
    int rb0, int rb, int G, const F32Args& a, int& lo, int& hi) {
  const int last = (rb0 + rb < a.Tq * G ? rb0 + rb : a.Tq * G) - 1;
  const int p0 = a.q_offset + rb0 / G, p1 = a.q_offset + last / G;
  lo = a.window > 0 ? (p0 - a.window + 1 > 0 ? p0 - a.window + 1 : 0) : 0;
  hi = a.causal && p1 + 1 < a.kv_len ? p1 + 1 : a.kv_len;
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D, typename Loader>
__global__ void __launch_bounds__(F32_WARPS * 32)
flash_f32_kernel(F32Args p) {
  using Tl = F32Tile<D>;
  constexpr int RPL = Tl::RPL, RB = Tl::RB, LD = Tl::LD, LDP = Tl::LDP,
                KT = F32_KT, KPL = F32_KPL, NC = D / 16,
                NT = F32_WARPS * 32;
  extern __shared__ __align__(16) float f32s[];
  float* const qs = f32s;                              // [RB][LD], scaled
  float* const ps = qs + RB * LD;                      // [warp][RB][LDP]
  float* const fac = ps + F32_WARPS * RB * LDP;        // [(W + 2) RB]
  const int warp_floats = p.stages * Tl::STAGE;
  auto warp_part = [&](int w) { return f32s + Tl::HEAD + w * warp_floats; };

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 2, kg = lane & 3;   // rows rg + 8 i, keys kg + 4 j
  const int G = p.H / p.KVH, rows = p.Tq * G;
  const int kvh = blockIdx.y % p.KVH, b = blockIdx.y / p.KVH;
  const int rb0 = (gridDim.z - 1 - blockIdx.z) * RB;  // the latest rows first
  const Loader kv(p, b, kvh, D);
  float* const ring = warp_part(warp);
  float* const pw = ps + warp * RB * LDP;
  // the address of row r's head (position, query head), r < rows
  auto row_at = [&](auto* base, int r) {
    return base + (((long long)b * p.Tq + r / G) * p.H + kvh * G + r % G) * D;
  };

  int k_lo, k_hi;
  f32_block_keys(rb0, RB, G, p, k_lo, k_hi);
  const int t_end = k_hi > k_lo ? (k_hi + KT - 1) / KT : 0;
  const int n_split = CL * F32_WARPS;
  // Lane j < KT names row j of key tile t (one lookup); the lanes copying a
  // row's 16-byte chunks take its name by shuffle. Keys no row of the
  // block can see are never looked up or read: zero-filled (and masked).
  auto name_of = [&](int tile) {
    const int kl = tile * KT + (lane & (KT - 1));
    return lane < KT && kl >= k_lo && kl < k_hi ? kv.row(kl) : 0;
  };
  int t = k_lo / KT + rank * F32_WARPS + warp, stage = 0;
  const int name0 = t < t_end ? name_of(t) : 0;  // (paged: in flight with Q)

  // Q by 16-byte cp.async (rows past the last zero-filled), in flight
  // beside the first K/V tile; each thread scales the chunks it copied.
  for (int e = threadIdx.x; e < RB * D / 4; e += NT) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool ok = rb0 + r < rows;
    cp_async16(qs + r * LD + c, ok ? row_at(p.q, rb0 + r) + c : p.q, ok);
  }
  cp_async_commit();
  int qpos[RPL];       // rows past the last take the last position
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = rb0 + rg + 8 * i;
    qpos[i] = p.q_offset + (r < rows ? r / G : p.Tq - 1);
  }

  // Keys every row of the block sees, [all_lo, all_hi): tiles inside need
  // no mask.
  const int p_last = p.q_offset + (min(rb0 + RB, rows) - 1) / G;
  const int all_lo = p.window > 0 ? p_last - p.window + 1 : 0;
  const int all_hi = p.causal ? min(p.kv_len, p.q_offset + rb0 / G + 1)
                              : p.kv_len;

  auto load_tile = [&](int tile, int slot, int name) {
    float* ks = ring + slot * Tl::STAGE;
    float* vs = ks + KT * LD;
#pragma unroll
    for (int c = lane; c < KT * D / 4; c += 32) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      const int kpos = tile * KT + r;
      const bool ok = kpos >= k_lo && kpos < k_hi;
      const int nm = __shfl_sync(FULL, name, r);
      cp_async16(ks + r * LD + col, kv.k_row(nm) + col, ok);
      cp_async16(vs + r * LD + col, kv.v_row(nm) + col, ok);
    }
  };

  float acc[RPL][NC][4], m[RPL], l[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  }

  if (t < t_end) load_tile(t, 0, name0);
  cp_async_commit();
  cp_async_wait<1>();                     // this thread's Q chunks
  for (int e = threadIdx.x; e < RB * D / 4; e += NT) {
    float4* x = reinterpret_cast<float4*>(qs + (e / (D / 4)) * LD +
                                          (e % (D / 4)) * 4);
    float4 y = *x;
    y.x *= p.scale; y.y *= p.scale; y.z *= p.scale; y.w *= p.scale;
    *x = y;
  }
  __syncthreads();                        // Q is every warp's
  for (; t < t_end; t += n_split) {
    const int next = t + n_split;
    if (p.stages == 2 && next < t_end)
      load_tile(next, stage ^ 1, name_of(next));
    cp_async_commit();
    if (p.stages == 2) cp_async_wait<1>();  // tile t has landed
    else cp_async_wait<0>();
    __syncwarp();
    const float* ks = ring + stage * Tl::STAGE;
    const float* vs = ks + KT * LD;

    // S = Q K^T as an RPL x KPL micro-tile a lane: per 4 channels, RPL +
    // KPL vector reads feed 4 RPL KPL FMAs; each score one fmaf chain
    // over d.
    float s[RPL][KPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPL], kv4[KPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 8 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(ks + (kg + 4 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPL; ++i)
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

    // Softcap and mask (a tile every row sees whole needs none); online
    // softmax per row over its lane quad; P to the warp's shared tile.
    const bool whole = t * KT >= all_lo && t * KT + KT <= all_hi;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (!whole) {
          const int kpos = t * KT + kg + 4 * j;
          bool ok = kpos < p.kv_len;
          if (p.causal) ok = ok && kpos <= qpos[i];
          if (p.window > 0) ok = ok && kpos > qpos[i] - p.window;
          x = ok ? x : NEG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float e = expf(s[i][j] - mx);
        sum += e;
        pw[(rg + 8 * i) * LDP + kg + 4 * j] = e;
      }
      l[i] = l[i] * corr + sum;           // this lane's share of the row
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c][0] *= corr; acc[i][c][1] *= corr;
        acc[i][c][2] *= corr; acc[i][c][3] *= corr;
      }
    }
    __syncwarp();

    // acc += P V as an RPL x (4 x NC) micro-tile a lane (channels 4 kg +
    // 16 c, + 3): per 4 keys, RPL + 4 NC vector reads feed 16 RPL NC FMAs;
    // keys in order.
#pragma unroll
    for (int k4 = 0; k4 < KT; k4 += 4) {
      float4 pv[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pw + (rg + 8 * i) * LDP + k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (k4 + e) * LD + 4 * kg;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * c);
#pragma unroll
          for (int i = 0; i < RPL; ++i) {
            const float pk = at(pv[i], e);
            acc[i][c][0] = fmaf(pk, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pk, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pk, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pk, vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncwarp();                         // stage and P are free again
    if (p.stages == 2) stage ^= 1;
    else if (next < t_end) load_tile(next, 0, name_of(next));
  }
  cp_async_wait<0>();
  __syncwarp();

  // This warp's partial over its tiles, in its first stage. A warp that
  // saw no live key of a row holds m = NEG there and weighs 0.
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    if (kg == 0) {
      ring[rg + 8 * i] = m[i];
      ring[RB + rg + 8 * i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(ring + 2 * RB + (rg + 8 * i) * D + 4 * kg +
                                 16 * c) =
          make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
  }
  __syncthreads();

  // Merge the block's warps in warp order into warp 0's partial, in
  // place: each element is read and written by one thread.
  if (threadIdx.x < RB) {
    const int row = threadIdx.x;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < F32_WARPS; ++w) mm = fmaxf(mm, warp_part(w)[row]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < F32_WARPS; ++w) {
      const float f = expf(warp_part(w)[row] - mm);
      fac[w * RB + row] = f;
      ls += warp_part(w)[RB + row] * f;
    }
    fac[F32_WARPS * RB + row] = mm;
    fac[(F32_WARPS + 1) * RB + row] = ls;
  }
  __syncthreads();
  float* blk = warp_part(0);
  for (int e = threadIdx.x * 4; e < RB * D; e += NT * 4) {
    const int row = e / D;
    float4 a = *reinterpret_cast<const float4*>(blk + 2 * RB + e);
    const float f0 = fac[row];
    a.x *= f0; a.y *= f0; a.z *= f0; a.w *= f0;
#pragma unroll
    for (int w = 1; w < F32_WARPS; ++w) {
      const float4 v =
          *reinterpret_cast<const float4*>(warp_part(w) + 2 * RB + e);
      const float f = fac[w * RB + row];
      a.x += v.x * f; a.y += v.y * f; a.z += v.z * f; a.w += v.w * f;
    }
    *reinterpret_cast<float4*>(blk + 2 * RB + e) = a;
  }
  if (threadIdx.x < RB) {
    blk[threadIdx.x] = fac[F32_WARPS * RB + threadIdx.x];
    blk[RB + threadIdx.x] = fac[(F32_WARPS + 1) * RB + threadIdx.x];
  }
  if (CL > 1) cluster.sync();
  else __syncthreads();

  // Merge the cluster's block partials in rank order over distributed
  // shared memory; block `rank` finalizes the columns [rank * D / CL,
  // (rank + 1) * D / CL), four at a time.
  const int cols = D / CL, c0 = rank * cols;
  for (int e = threadIdx.x; e < RB * cols / 4; e += NT) {
    const int row = e / (cols / 4), c = c0 + (e % (cols / 4)) * 4;
    float mb[F32_MAX_CLUSTER], lb[F32_MAX_CLUSTER];
    float4 ab[F32_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < F32_MAX_CLUSTER; ++r) {
      if (r < CL) {
        const float* pr = CL > 1 ? cluster.map_shared_rank(blk, r) : blk;
        mb[r] = pr[row];
        lb[r] = pr[RB + row];
        ab[r] = *reinterpret_cast<const float4*>(pr + 2 * RB + row * D + c);
      }
    }
    if (rb0 + row >= rows) continue;
    float mm = NEG;
#pragma unroll
    for (int r = 0; r < F32_MAX_CLUSTER; ++r)
      if (r < CL) mm = fmaxf(mm, mb[r]);
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < F32_MAX_CLUSTER; ++r) {
      if (r < CL) {
        const float f = expf(mb[r] - mm);
        ls += lb[r] * f;
        o.x += ab[r].x * f; o.y += ab[r].y * f;
        o.z += ab[r].z * f; o.w += ab[r].w * f;
      }
    }
    ls = fmaxf(ls, 1e-37f);
    *reinterpret_cast<float4*>(row_at(p.o, rb0 + row) + c) =
        make_float4(o.x / ls, o.y / ls, o.z / ls, o.w / ls);
  }
  if (CL > 1) cluster.sync();             // peers stop reading our partials
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The fp32 kernel's grid: row tiles (nrb) x kv heads x sequences, in
// clusters of cl blocks. The busiest row tile's key tiles go one to a warp
// where the block's warps alone are too few, doubling the cluster (at most
// F32_MAX_CLUSTER) while the grid is short of the SMs; a warp streams two
// stages where it has more than one tile (one for D = 256).
template <int D>
int f32_plan(const F32Args& a, int batch, int& nrb, int& stages) {
  constexpr int RB = F32Tile<D>::RB;
  const int G = a.H / a.KVH;
  nrb = (a.Tq * G + RB - 1) / RB;
  int most = 0;
  for (int rb0 = 0; rb0 < a.Tq * G; rb0 += RB) {
    int lo, hi;
    f32_block_keys(rb0, RB, G, a, lo, hi);
    if (hi > lo) {
      const int n = (hi + F32_KT - 1) / F32_KT - lo / F32_KT;
      most = n > most ? n : most;
    }
  }
  const long long blocks = (long long)nrb * a.KVH * batch;
  int cl = 1;
  while (cl < F32_MAX_CLUSTER && cl * F32_WARPS < most &&
         blocks * cl < sm_count())
    cl *= 2;
  stages = F32Tile<D>::MAX_STAGES > 1 && most > cl * F32_WARPS ? 2 : 1;
  return cl;
}

// The fp32 kernel's geometry, as flash_tc_geom (a grid of no blocks where
// there are no rows or no sequences: nothing launches).
template <int D>
bool f32_geom(const F32Args& a, int batch, int cluster, int stages,
              FlashGeom& g) {
  int nrb;
  g.cluster = f32_plan<D>(a, batch, nrb, g.stages);
  if (cluster != 0 || stages != 0) {
    if (!flash_override(cluster, stages, F32_MAX_CLUSTER,
                        F32Tile<D>::MAX_STAGES))
      return false;
    g.cluster = cluster;
    g.stages = stages;
  }
  if (nrb > 65535 || (long long)a.KVH * batch > 65535) return false;
  g.grid = dim3(g.cluster, a.KVH * batch, nrb);
  g.threads = F32_WARPS * 32;
  g.smem = F32Tile<D>::smem(g.stages);
  return true;
}

template <int D, typename Loader>
cudaError_t launch_f32(F32Args a, int batch, int cluster, int stages,
                       cudaStream_t s) {
  FlashGeom g;
  if (!f32_geom<D>(a, batch, cluster, stages, g))
    return cudaErrorInvalidValue;
  a.stages = g.stages;
  const int cl = g.cluster;
  if (g.grid.z == 0 || batch == 0) return cudaSuccess;
  auto kernel = flash_f32_kernel<D, Loader>;
  static bool configured = false;     // per instantiation: per loader
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F32Tile<D>::smem(F32Tile<D>::MAX_STAGES));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = g.grid;
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;   // a launch without clusters is one of 1
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename Loader>
cudaError_t f32_by_dim(int D, const F32Args& a, int batch, int cluster,
                       int stages, cudaStream_t s) {
  switch (D) {
    case 16: return launch_f32<16, Loader>(a, batch, cluster, stages, s);
    case 32: return launch_f32<32, Loader>(a, batch, cluster, stages, s);
    case 64: return launch_f32<64, Loader>(a, batch, cluster, stages, s);
    case 128: return launch_f32<128, Loader>(a, batch, cluster, stages, s);
    case 256: return launch_f32<256, Loader>(a, batch, cluster, stages, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Decode, dense and paged: the live keys split over blocks, merged in the
// same launch.
// ---------------------------------------------------------------------------
constexpr int DS_WARPS = 8;
// Keys per block. A sweep of 32, 64, 128 and 256 on the H100, at B=1 S=784
// and at B=4 S=2048 (MQA, D=256), found 64 fastest at both (PERF.md). A
// caller's plan may name another: a multiple of 16 up to DS_MAX_SPLIT.
constexpr int DS_SPLIT = 64;
constexpr int DS_MAX_SPLIT = 4096;

struct SplitArgs {
  const void* q;       // (B, 1, H, D) contiguous
  const void* k;       // dense: (B, S, KVH, D); paged: pool (KVH, NPOOL, PAGE, D)
  const void* v;
  void* o;             // (B, 1, H, D)
  float* ws;           // [groups][n_splits][REP][D + 2] partials
  int* tickets;        // [groups], 0 before a launch and again after it
  int H, KVH;
  int S, pos;          // dense: keys <= pos of S are live
  const int* tables;   // paged: (B, MP) page ids
  const int* lengths;  // paged: (B,) live tokens incl. the current one
  int MP, npool, page; // paged geometry
  int window;          // 0 = global
  int n_splits;        // blocks per (sequence, kv head, head group): the grid
  int split;           // keys per split (DS_SPLIT unless the caller's plan)
  int nz, groups;      // head groups per kv head; B * KVH * nz
  float softcap;       // 0 = none
  float scale;
};

// A lane group of G lanes reads one key row in 16-byte vectors, E elements
// a lane; NG groups per block.
template <int D, typename T>
struct SplitShape {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int G = D / VEC < 32 ? D / VEC : 32;
  static constexpr int E = D / G;
  static constexpr int NG = DS_WARPS * 32 / G;
  static constexpr int WORDS = E * (int)sizeof(T) / 16;   // uint4 per row
};

// The live key range [lo, hi) of one decode step.
__host__ __device__ __forceinline__ void decode_keys(int S, int pos,
                                                     int window, int& lo,
                                                     int& hi) {
  lo = window > 0 && pos - window + 1 > 0 ? pos - window + 1 : 0;
  hi = pos + 1 < S ? pos + 1 : S;
  if (hi < 0) hi = 0;
}

// The split decode kernel's K/V loader policies: the live keys [lo, hi) of
// sequence b; where split 0 starts (split s covers [first + s * split,
// first + (s + 1) * split) inside [lo, hi)); and where key row kpos of
// kv head kvh lies, in 16-byte words from channel d0.
//
// Dense: the range from the host's pos, splits from lo (the host plans
// exactly the live splits).
template <typename T>
struct DenseDecodeKV {
  const uint4* k;
  const uint4* v;
  long long row_words;   // 16-byte words between consecutive keys
  int lo, hi, first;
  __device__ DenseDecodeKV(const SplitArgs& p, int b, int kvh, int D,
                           int d0) {
    const long long row = (long long)p.KVH * D;
    const long long base = (long long)b * p.S * row + (long long)kvh * D + d0;
    k = reinterpret_cast<const uint4*>(static_cast<const T*>(p.k) + base);
    v = reinterpret_cast<const uint4*>(static_cast<const T*>(p.v) + base);
    row_words = row * (long long)sizeof(T) / 16;
    decode_keys(p.S, p.pos, p.window, lo, hi);
    first = lo;
  }
  __device__ const uint4* k_row(int kpos) const { return k + kpos * row_words; }
  __device__ const uint4* v_row(int kpos) const { return v + kpos * row_words; }
};

// Paged: the range from the slot's length in device memory (the host never
// reads it, so a step's launch is the same whatever the lengths), within
// the table's reach; splits on multiples of the split, so where the page
// divides it a split covers whole pages (page 64: one page, one
// table entry). A row's page comes from the slot's block table; a key
// outside [lo, hi) is never read, nor its table entry.
template <typename T>
struct PagedDecodeKV {
  const T* k;
  const T* v;
  const int* table;
  int page, dim, lo, hi, first;
  __device__ PagedDecodeKV(const SplitArgs& p, int b, int kvh, int D,
                           int d0) {
    const long long base = (long long)kvh * p.npool * p.page * D + d0;
    k = static_cast<const T*>(p.k) + base;
    v = static_cast<const T*>(p.v) + base;
    table = p.tables + (long long)b * p.MP;
    page = p.page;
    dim = D;
    decode_keys(p.MP * p.page, p.lengths[b] - 1, p.window, lo, hi);
    first = lo / p.split * p.split;
  }
  __device__ long long row(int kpos) const {
    return ((long long)__ldg(table + kpos / page) * page + kpos % page) * dim;
  }
  __device__ const uint4* k_row(int kpos) const {
    return reinterpret_cast<const uint4*>(k + row(kpos));
  }
  __device__ const uint4* v_row(int kpos) const {
    return reinterpret_cast<const uint4*>(v + row(kpos));
  }
};

template <typename T, int E>
__device__ __forceinline__ void to_float(const uint4 (&w)[E * sizeof(T) / 16],
                                         float (&out)[E]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < E / 8; ++j) {
      const auto* h =
          reinterpret_cast<const typename Pair<T>::type*>(&w[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = Pair<T>::f2(h[i]);
        out[8 * j + 2 * i] = f.x;
        out[8 * j + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      out[4 * j] = __uint_as_float(w[j].x);
      out[4 * j + 1] = __uint_as_float(w[j].y);
      out[4 * j + 2] = __uint_as_float(w[j].z);
      out[4 * j + 3] = __uint_as_float(w[j].w);
    }
  }
}

template <int D, typename T, int REP, typename Loader>
__global__ void __launch_bounds__(DS_WARPS * 32, 1)
decode_split_kernel(SplitArgs p) {
  using Sh = SplitShape<D, T>;
  constexpr int G = Sh::G, E = Sh::E, NG = Sh::NG, W = Sh::WORDS;
  // Key rows a group has in flight: a 64-key split in one round where the
  // registers allow (one 16-byte word a row, four query heads).
  constexpr int U = REP <= 4 && W == 1 ? 8 : 4;
  extern __shared__ float red[];           // [NG][REP][D + 2]
  __shared__ int last;
  __shared__ float m_all[REP], l_all[REP];
  const T* q = static_cast<const T*>(p.q);
  T* o = static_cast<T*>(p.o);
  const int tid = threadIdx.x, grp = tid / G, gl = tid % G;
  const int split = blockIdx.x, gi = blockIdx.y;
  const int z = gi % p.nz, bk = gi / p.nz;
  const int kvh = bk % p.KVH, b = bk / p.KVH;
  const int rep = p.H / p.KVH, r0 = z * REP;
  const int nrep = min(REP, rep - r0);
  const int d0 = gl * E;

  // This group's live splits; a block past them returns before its ticket.
  // A sequence with no live key still has one split: it writes a zero row.
  const Loader kv(p, b, kvh, D, d0);
  const int live = kv.hi > kv.lo
                       ? (kv.hi - kv.first + p.split - 1) / p.split : 1;
  if (split >= live) return;
  const int k_lo = max(kv.lo, kv.first + split * p.split);
  const int k_hi = min(kv.hi, kv.first + (split + 1) * p.split);

  float qr[REP][E], acc[REP][E], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < E; ++c) { qr[r][c] = 0.f; acc[r][c] = 0.f; }
    if (r < nrep) {
      const int h = kvh * rep + r0 + r;
      load_row<T, E>(q + ((long long)b * p.H + h) * D + d0, qr[r]);
#pragma unroll
      for (int c = 0; c < E; ++c) qr[r][c] *= p.scale;
    }
  }

  // Every group runs the same number of rounds, so the shuffles inside a
  // group never diverge; a key past the split only skips the update.
  for (int base = k_lo; base < k_hi; base += NG * U) {
    uint4 kw[U][W], vw[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kpos = base + u * NG + grp;
      if (kpos < k_hi) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          kw[u][j] = kv.k_row(kpos)[j];
          vw[u][j] = kv.v_row(kpos)[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j)
          kw[u][j] = vw[u][j] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = base + u * NG + grp < k_hi;
      float kf[E], vf[E];
      to_float<T, E>(kw[u], kf);
      to_float<T, E>(vw[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= nrep) break;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < E; ++c) s = fmaf(qr[r][c], kf[c], s);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(FULL, s, off);
        if (!live) continue;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float pv = expf(s - m_new);
        l[r] = l[r] * corr + pv;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < E; ++c)
          acc[r][c] = fmaf(pv, vf[c], acc[r][c] * corr);
      }
    }
  }

  // The block's partial: its groups merged in group order. A group that
  // saw no key holds (NEG, 0, 0) and adds nothing.
  float* mine = red + (long long)grp * REP * (D + 2);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= nrep) break;
    if (gl == 0) {
      mine[r * (D + 2) + D] = m[r];
      mine[r * (D + 2) + D + 1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < E; ++c) mine[r * (D + 2) + d0 + c] = acc[r][c];
  }
  __syncthreads();
  const int h0 = kvh * rep + r0;
  if (live == 1) {                         // one split: no workspace
    for (int e = tid; e < nrep * D; e += DS_WARPS * 32) {
      const int r = e / D, d = e % D;
      float mm = NEG;
      for (int w = 0; w < NG; ++w)
        mm = fmaxf(mm, red[((long long)w * REP + r) * (D + 2) + D]);
      float ls = 0.f, os = 0.f;
      for (int w = 0; w < NG; ++w) {
        const float* pw = red + ((long long)w * REP + r) * (D + 2);
        const float f = expf(pw[D] - mm);
        ls += pw[D + 1] * f;
        os += pw[d] * f;
      }
      st(o + ((long long)b * p.H + h0 + r) * D + d, os / fmaxf(ls, 1e-37f));
    }
    return;
  }
  const long long part_stride = (long long)REP * (D + 2);
  float* ws_split = p.ws + ((long long)gi * p.n_splits + split) * part_stride;
  for (int e = tid; e < nrep * (D + 2); e += DS_WARPS * 32) {
    const int r = e / (D + 2), d = e % (D + 2);
    float mm = NEG;
    for (int w = 0; w < NG; ++w)
      mm = fmaxf(mm, red[((long long)w * REP + r) * (D + 2) + D]);
    float val = mm;
    if (d != D) {
      val = 0.f;
      for (int w = 0; w < NG; ++w) {
        const float* pw = red + ((long long)w * REP + r) * (D + 2);
        val += pw[d] * expf(pw[D] - mm);
      }
    }
    ws_split[r * (D + 2) + d] = val;
  }

  // The last live block of this (sequence, kv head, head group) merges
  // every split in a fixed order and leaves the ticket at 0 for the next
  // launch (no memset).
  __threadfence();                         // release the partial
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.tickets + gi, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                         // acquire the others'
  if (tid == 0) p.tickets[gi] = 0;
  const float* ws_g = p.ws + (long long)gi * p.n_splits * part_stride;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < nrep) {                       // head `warp`: max and sum
    float mm = NEG;
    for (int sp = lane; sp < live; sp += 32)
      mm = fmaxf(mm, __ldcg(ws_g + sp * part_stride + warp * (D + 2) + D));
    mm = warp_max(mm);
    float ls = 0.f;
    for (int sp = lane; sp < live; sp += 32) {
      const float* pr = ws_g + sp * part_stride + warp * (D + 2);
      ls += __ldcg(pr + D + 1) * expf(__ldcg(pr + D) - mm);
    }
    ls = warp_sum(ls);
    if (lane == 0) { m_all[warp] = mm; l_all[warp] = fmaxf(ls, 1e-37f); }
  }
  __syncthreads();
  for (int e = tid; e < nrep * D; e += DS_WARPS * 32) {
    const int r = e / D, d = e % D;
    float os = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
      const float* pr = ws_g + sp * part_stride + r * (D + 2);
      os += __ldcg(pr + d) * expf(__ldcg(pr + D) - m_all[r]);
    }
    st(o + ((long long)b * p.H + h0 + r) * D + d, os / l_all[r]);
  }
}

// Query heads per block: every head of a kv head where there are at most 8.
inline int split_rep(int H, int KVH) { return H / KVH <= 4 ? 4 : 8; }

// plan: [0] splits (the grid's, per group), [1] groups (B * KVH * head
// groups), [2] query heads per block, [3] keys per split, [4] 4-byte words
// of partials (none where a group has one split). Each group also takes
// one ticket, in a buffer of its own.
void fill_plan(int splits, int split, int B, int H, int KVH, int D,
               long long* plan) {
  const int rep_blk = split_rep(H, KVH);
  const int rep = H / KVH;
  plan[0] = splits;
  plan[1] = (long long)B * KVH * ((rep + rep_blk - 1) / rep_blk);
  plan[2] = rep_blk;
  plan[3] = split;
  plan[4] = splits > 1 ? splits * plan[1] * rep_blk * (D + 2LL) : 0;
}

// Keys per split: DS_SPLIT for 0, else the caller's (a multiple of 16 up
// to DS_MAX_SPLIT), or 0 where it is none of these.
inline int split_keys(int split) {
  if (split == 0) return DS_SPLIT;
  return split >= 16 && split <= DS_MAX_SPLIT && split % 16 == 0 ? split : 0;
}

// Dense: exactly the live splits of the host's pos.
void decode_plan(int B, int S, int H, int KVH, int D, int pos, int window,
                 int split, long long* plan) {
  int lo, hi;
  decode_keys(S, pos, window, lo, hi);
  const int live = hi > lo ? hi - lo : 0;
  fill_plan(live > 0 ? (live + split - 1) / split : 1, split, B, H, KVH, D,
            plan);
}

// Paged: from the shapes alone, the most splits any length can make live:
// the table's reach, or a window (one more where it starts mid-split).
void paged_plan(int S, int MP, int page, int H, int KVH, int D, int window,
                int split, long long* plan) {
  const long long reach = (long long)MP * page;
  long long splits = (reach + split - 1) / split;
  if (window > 0) {
    const long long w = (window + split - 1) / split + 1;
    if (w < splits) splits = w;
  }
  fill_plan(splits > 1 ? (int)splits : 1, split, S, H, KVH, D, plan);
}

template <int D, typename T, int REP, typename Loader>
cudaError_t launch_split(const SplitArgs& a, cudaStream_t s) {
  using Sh = SplitShape<D, T>;
  const int smem = (int)sizeof(float) * Sh::NG * REP * (D + 2);
  auto kernel = decode_split_kernel<D, T, REP, Loader>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(a.n_splits, a.groups);
  kernel<<<grid, DS_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int REP, template <typename> class Loader>
cudaError_t split_by_dim(int D, const SplitArgs& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch_split<16, T, REP, Loader<T>>(a, s);
    case 32: return launch_split<32, T, REP, Loader<T>>(a, s);
    case 64: return launch_split<64, T, REP, Loader<T>>(a, s);
    case 128: return launch_split<128, T, REP, Loader<T>>(a, s);
    case 256: return launch_split<256, T, REP, Loader<T>>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename> class Loader>
cudaError_t split_dispatch(int dtype, int D, int rep_blk, const SplitArgs& a,
                           cudaStream_t s) {
  if (dtype == DT_BF16)
    return rep_blk == 4 ? split_by_dim<bf16, 4, Loader>(D, a, s)
                        : split_by_dim<bf16, 8, Loader>(D, a, s);
  if (dtype == DT_F16)
    return rep_blk == 4 ? split_by_dim<__half, 4, Loader>(D, a, s)
                        : split_by_dim<__half, 8, Loader>(D, a, s);
  return rep_blk == 4 ? split_by_dim<float, 4, Loader>(D, a, s)
                      : split_by_dim<float, 8, Loader>(D, a, s);
}

// A flash call's geometry, as plan[0..6]: blocks per cluster, K/V stages
// a warp, the grid (x: the cluster's blocks; bf16: y row tiles of 16, z
// heads x batch; fp32: y kv heads x batch, z row tiles of the kv head's
// (position, query head) pairs, 0 where nothing launches), threads per
// block, dynamic shared memory bytes. The caller's (cluster, stages), 0, 0
// for the call's own; false where the kernel cannot run them.
template <int D>
bool flash_geom_of(int dtype, const FlashArgs& a, const F32Args& f,
                   int batch, int cluster, int stages, FlashGeom& g) {
  return dtype != DT_F32 ? flash_tc_geom<D>(a, batch, cluster, stages, g)
                         : f32_geom<D>(f, batch, cluster, stages, g);
}

bool flash_geom_plan(int D, int dtype, const FlashArgs& a, const F32Args& f,
                     int batch, int cluster, int stages, long long* plan) {
  FlashGeom g{};
  bool ok = false;
  switch (D) {
    case 16: ok = flash_geom_of<16>(dtype, a, f, batch, cluster, stages, g);
      break;
    case 32: ok = flash_geom_of<32>(dtype, a, f, batch, cluster, stages, g);
      break;
    case 64: ok = flash_geom_of<64>(dtype, a, f, batch, cluster, stages, g);
      break;
    case 128: ok = flash_geom_of<128>(dtype, a, f, batch, cluster, stages, g);
      break;
    case 256: ok = flash_geom_of<256>(dtype, a, f, batch, cluster, stages, g);
      break;
    default: break;
  }
  if (!ok) return false;
  const long long out[7] = {g.cluster, g.stages, g.grid.x, g.grid.y,
                            g.grid.z, g.threads, g.smem};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return true;
}

}  // namespace

// flash_attention: q (B, Tq, H, D), k / v (B, Tk, KVH, D), queries
// right-aligned to the keys. cluster, stages: the caller's plan (blocks
// per cluster 1, 2 or 4; stages 1 or 2, fp32 at D = 256 only 1), or 0, 0
// for the call's own (flash_attention_plan reports either); a plan the
// kernel cannot run is cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
    int H, int KVH, int D, int causal, int window, float softcap, float scale,
    int dtype, void* stream, int cluster, int stages) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != DT_F32) {   // bf16 or fp16: 16-bit storage, moved as bits
    FlashArgs a{};
    a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v); a.o = static_cast<bf16*>(o);
    a.Tq = Tq; a.Tk = Tk; a.H = H; a.KVH = KVH; a.q_offset = Tk - Tq;
    a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
    return (int)flash_tc_dispatch<DenseKV>(dtype, D, a, B, cluster, stages,
                                           s);
  }
  F32Args a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.o = static_cast<float*>(o);
  a.table = nullptr;
  a.Tq = Tq; a.H = H; a.KVH = KVH;
  a.q_offset = Tk - Tq; a.kv_len = Tk;
  a.causal = causal; a.window = window; a.npool = 0; a.page = 1;
  a.softcap = softcap; a.scale = scale;
  return (int)f32_by_dim<DenseKV32>(D, a, B, cluster, stages, s);
}

// The geometry flash_attention_launch runs for these arguments and the
// caller's (cluster, stages), 0, 0 for the call's own (see
// flash_geom_plan); launches nothing. A plan the kernel cannot run is
// cudaErrorInvalidValue, as at launch.
extern "C" int flash_attention_plan(int B, int Tq, int Tk, int H, int KVH,
                                    int D, int causal, int window, int dtype,
                                    int cluster, int stages,
                                    long long* plan) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  FlashArgs a{};
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.KVH = KVH; a.q_offset = Tk - Tq;
  a.causal = causal; a.window = window;
  F32Args f{};
  f.Tq = Tq; f.H = H; f.KVH = KVH; f.q_offset = Tk - Tq; f.kv_len = Tk;
  f.causal = causal; f.window = window; f.page = 1;
  return flash_geom_plan(D, dtype, a, f, B, cluster, stages, plan)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// bf16: the tensor-core flash kernel through PagedKV, the queries at
// [start, start + Tq), keys [0, start + Tq); its grid and cluster come
// from these arguments alone. fp32: the CUDA-core flash kernel through
// PagedKV32 (IEEE fp32), likewise.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    void* o, int Tq, int start, int H, int KVH, int D, int npool, int page,
    int window, float softcap, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != DT_F32) {   // bf16 or fp16
    FlashArgs a{};
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k_pool);
    a.v = static_cast<const bf16*>(v_pool);
    a.o = static_cast<bf16*>(o);
    a.table = table; a.npool = npool; a.page = page;
    a.Tq = Tq; a.Tk = start + Tq; a.H = H; a.KVH = KVH; a.q_offset = start;
    a.causal = 1; a.window = window; a.softcap = softcap; a.scale = scale;
    return (int)flash_tc_dispatch<PagedKV>(dtype, D, a, 1, 0, 0, s);
  }
  F32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k_pool);
  a.v = static_cast<const float*>(v_pool);
  a.o = static_cast<float*>(o);
  a.table = table;
  a.Tq = Tq; a.H = H; a.KVH = KVH;
  a.q_offset = start; a.kv_len = start + Tq;
  a.causal = 1; a.window = window; a.npool = npool; a.page = page;
  a.softcap = softcap; a.scale = scale;
  return (int)f32_by_dim<PagedKV32>(D, a, 1, 0, 0, s);
}

// The geometry paged_prefill_launch runs for these arguments, its own
// plan (see flash_geom_plan; the pools' geometry does not enter it);
// launches nothing.
extern "C" int paged_prefill_plan(int Tq, int start, int H, int KVH, int D,
                                  int window, int dtype, long long* plan) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  FlashArgs a{};
  a.Tq = Tq; a.Tk = start + Tq; a.H = H; a.KVH = KVH; a.q_offset = start;
  a.causal = 1; a.window = window;
  F32Args f{};
  f.Tq = Tq; f.H = H; f.KVH = KVH; f.q_offset = start;
  f.kv_len = start + Tq; f.causal = 1; f.window = window; f.page = 1;
  return flash_geom_plan(D, dtype, a, f, 1, 0, 0, plan)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The split decode kernel's plan for a dense call (see decode_plan) and for
// a paged one (see paged_plan); launch nothing. The paged call's split:
// keys per split, 0 for DS_SPLIT, else a multiple of 16 up to
// DS_MAX_SPLIT (the caller's plan; another value is
// cudaErrorInvalidValue).
extern "C" int decode_attention_plan(int B, int S, int H, int KVH, int D,
                                     int pos, int window, long long* plan) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  decode_plan(B, S, H, KVH, D, pos, window, DS_SPLIT, plan);
  return 0;
}

extern "C" int paged_decode_plan(int S, int MP, int page, int H, int KVH,
                                 int D, int window, int split,
                                 long long* plan) {
  const int keys = split_keys(split);
  if (KVH <= 0 || H % KVH || MP <= 0 || page <= 0 || keys == 0)
    return (int)cudaErrorInvalidValue;
  paged_plan(S, MP, page, H, KVH, D, window, keys, plan);
  return 0;
}

// ws: the plan's partials (plan[4] words); tickets: plan[1] ints, 0 on
// entry, left at 0 by the kernel. Calls on other streams need their own.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KVH, int D, int pos, int window, float softcap, float scale, int dtype,
    void* stream, float* ws, int* tickets) {
  long long plan[5];
  const int err = decode_attention_plan(B, S, H, KVH, D, pos, window, plan);
  if (err) return err;
  SplitArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.ws = ws; a.tickets = tickets;
  a.n_splits = (int)plan[0]; a.groups = (int)plan[1];
  a.split = (int)plan[3];
  a.H = H; a.KVH = KVH; a.S = S; a.pos = pos; a.window = window;
  a.nz = (H / KVH + (int)plan[2] - 1) / (int)plan[2];
  a.softcap = softcap; a.scale = scale;
  return (int)split_dispatch<DenseDecodeKV>(
      dtype, D, (int)plan[2], a, static_cast<cudaStream_t>(stream));
}

// One launch whatever the lengths: the grid comes from the shapes, and
// each block reads its slot's length on the card. split: as for
// paged_decode_plan.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* lengths, void* o, int S, int MP, int H, int KVH, int D,
    int npool, int page, int window, float softcap, float scale, int dtype,
    void* stream, float* ws, int* tickets, int split) {
  long long plan[5];
  const int err =
      paged_decode_plan(S, MP, page, H, KVH, D, window, split, plan);
  if (err) return err;
  SplitArgs a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.o = o; a.ws = ws;
  a.tickets = tickets; a.tables = tables; a.lengths = lengths;
  a.n_splits = (int)plan[0]; a.groups = (int)plan[1];
  a.split = (int)plan[3];
  a.H = H; a.KVH = KVH; a.MP = MP; a.npool = npool; a.page = page;
  a.window = window;
  a.nz = (H / KVH + (int)plan[2] - 1) / (int)plan[2];
  a.softcap = softcap; a.scale = scale;
  return (int)split_dispatch<PagedDecodeKV>(
      dtype, D, (int)plan[2], a, static_cast<cudaStream_t>(stream));
}
