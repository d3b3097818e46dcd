// Attention kernels for Hopper: flash (fresh prompt), paged prefill
// (continuation chunk), paged decode (one token per slot) and dense decode
// (one token against a contiguous cache, the static reference path).
//
// Replaces, in src/repro/kernels/attention.py, and the kernel each entry
// point reaches per dtype:
//   flash_attention          (_attn_kernel)          bf16 -> flash_tc_kernel<D, DenseKV>
//                                                    fp32 -> prefill_attn_kernel<D, float, false>
//   paged_prefill_attention  (_paged_prefill_kernel) both -> prefill_attn_kernel<D, T, true>
//   paged_decode_attention   (_paged_decode_kernel)  both -> paged_decode_kernel
//   decode_attention         (_decode_kernel)        both -> decode_split_kernel<D, T, REP, DenseDecodeKV>
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
//    addressing is a loader policy (DenseKV), so a paged loader can reuse
//    the kernel.
//  * prefill_attn_kernel (fp32 flash, paged prefill): CUDA-core fp32 FMAs
//    (IEEE fp32, which the tensor cores do not offer), a 64-row query tile
//    in shared memory, 32-key K/V tiles; tiles no row can see are skipped
//    (the TPU kernels' block_live), so a local layer costs O(T * window).
//  * Decode (paged and dense): bytes, and at one sequence, latency. One
//    query per head reads every live K/V row once; a block handles the
//    query heads of its kv head together (up to 4 in paged decode, 8 in
//    dense), so K/V are read once per kv head (GQA). Keys before the
//    window or past the length are never read. paged_decode_kernel runs
//    one block per (slot, kv head, head group) and finds pages through the
//    block table in device memory. decode_split_kernel splits the live
//    keys [max(0, pos - window + 1), min(pos + 1, S)) into splits of
//    DS_SPLIT = 64 keys, one block each, with 16-byte vector loads; each
//    block writes its partial (m, l, acc) to a workspace, and the last
//    block of a (sequence, kv head, head group) to finish -- found by an
//    atomic ticket, zeroed on the stream before each launch -- merges the
//    splits in a fixed order, in the same launch (a single split finalizes
//    in place). Its key range and row addressing are a loader policy
//    (DenseDecodeKV), as flash's are (DenseKV).
//
// Head dims 16, 32, 64, 128 and 256 are compiled; inputs are fp32 or bf16
// (accumulation is always fp32, output in the input type).
//
// C interface: flash_attention_launch, paged_prefill_launch,
// paged_decode_launch, decode_attention_launch (each returns
// cudaGetLastError()), and decode_attention_plan, which reports the grid
// and the workspace a decode call will use.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <float.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr float NEG = -0.7f * FLT_MAX;
constexpr unsigned FULL = 0xffffffffu;
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
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
// Prefill: a 64-row query tile against 32-key K/V tiles.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 32;         // keys per tile (one per lane)
constexpr int PF_WARPS = 16;    // 4 query rows per warp
constexpr int ROWS = BQ / PF_WARPS;

struct PrefillArgs {
  const void* q;       // (B, Tq, H, D) contiguous
  const void* k;       // dense: (B, Tk, KVH, D); paged: pool (KVH, NPOOL, PAGE, D)
  const void* v;
  void* o;             // (B, Tq, H, D)
  const int* table;    // paged: logical page -> pool page
  long long kv_bstride, kv_tstride;   // dense K/V strides (elements)
  int Tq, H, KVH;
  int q_offset;        // global position of query row 0
  int kv_len;          // live keys are [0, kv_len)
  int causal, window;  // window 0 = global
  int npool, page;     // paged geometry
  float softcap;       // 0 = none
  float scale;
};

template <int D, typename T, bool PAGED>
__global__ void __launch_bounds__(PF_WARPS * 32)
prefill_attn_kernel(PrefillArgs p) {
  constexpr int DPL = (D + 31) / 32;       // channels per lane in P @ V
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D], pre-scaled
  float* Ks = Qs + BQ * D;                 // [BKV][D + 1]
  float* Vs = Ks + BKV * (D + 1);          // [BKV][D]

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = p.q_offset + row0;        // global position of the tile

  for (int e = tid; e < BQ * D; e += PF_WARPS * 32) {
    const int r = e / D, d = e % D, gr = row0 + r;
    Qs[e] = gr < p.Tq
        ? ld(q + (((long long)b * p.Tq + gr) * p.H + h) * D + d) * p.scale
        : 0.f;
  }

  // Keys any row of the tile can see; whole tiles outside are skipped.
  int k_lo = 0, k_hi = p.kv_len;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(k_hi, q0 + BQ);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (k_lo / BKV) * BKV; k0 < k_hi; k0 += BKV) {
    __syncthreads();                       // last tile's readers are done
    for (int e = tid; e < BKV * D; e += PF_WARPS * 32) {
      const int kr = e / D, d = e % D, kpos = k0 + kr;
      float kval = 0.f, vval = 0.f;
      if (kpos < p.kv_len) {
        long long base;
        if constexpr (PAGED) {
          const int pg = p.table[kpos / p.page];
          base = (((long long)kvh * p.npool + pg) * p.page + kpos % p.page) * D;
        } else {
          base = (long long)b * p.kv_bstride + (long long)kpos * p.kv_tstride +
                 (long long)kvh * D;
        }
        kval = ld(k + base + d);
        vval = ld(v + base + d);
      }
      Ks[kr * (D + 1) + d] = kval;
      Vs[kr * D + d] = vval;
    }
    __syncthreads();

    // Scores: lane = key, the warp's ROWS query rows.
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        s[r] = fmaf(Qs[(warp * ROWS + r) * D + d], kd, s[r]);
    }

    const int kpos = k0 + lane;
    float pr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float sv = s[r];
      if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
      const int qpos = q0 + warp * ROWS + r;
      bool ok = kpos < p.kv_len;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      sv = ok ? sv : NEG;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float pv = expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pv);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      pr[r] = pv;
    }

    // acc += P @ V: lane owns channels lane + 32 * c.
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pk[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pk[r] = __shfl_sync(FULL, pr[r], kk);
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        const float vv = d < D ? Vs[kk * D + d] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(pk[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gr = row0 + warp * ROWS + r;
    if (gr >= p.Tq) continue;
    const float lf = fmaxf(l[r], 1e-37f);
    T* out = o + (((long long)b * p.Tq + gr) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) st(out + d, acc[r][c] / lf);
    }
  }
}

template <int D, typename T, bool PAGED>
cudaError_t launch_prefill(const PrefillArgs& a, int batch, cudaStream_t s) {
  const size_t smem = sizeof(float) * (BQ * D + BKV * (D + 1) + BKV * D);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attn_kernel<D, T, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, batch);
  prefill_attn_kernel<D, T, PAGED><<<grid, PF_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t prefill_by_dim(int D, const PrefillArgs& a, int batch,
                           cudaStream_t s) {
  switch (D) {
    case 16: return launch_prefill<16, T, PAGED>(a, batch, s);
    case 32: return launch_prefill<32, T, PAGED>(a, batch, s);
    case 64: return launch_prefill<64, T, PAGED>(a, batch, s);
    case 128: return launch_prefill<128, T, PAGED>(a, batch, s);
    case 256: return launch_prefill<256, T, PAGED>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
cudaError_t prefill_dispatch(int dtype, int D, const PrefillArgs& a, int batch,
                             cudaStream_t s) {
  if (dtype == DT_BF16) return prefill_by_dim<__nv_bfloat16, PAGED>(D, a, batch, s);
  return prefill_by_dim<float, PAGED>(D, a, batch, s);
}


// ---------------------------------------------------------------------------
// Paged decode: one block per (slot, kv head, group of up to 4 query heads).
// ---------------------------------------------------------------------------
constexpr int DC_WARPS = 8;
constexpr int DC_REP = 4;       // query heads per block

struct DecodeArgs {
  const void* q;         // (S, 1, H, D) contiguous
  const void* k;         // pool (KVH, NPOOL, PAGE, D)
  const void* v;
  void* o;               // (S, 1, H, D)
  const int* tables;     // paged: (S, MP) page ids
  const int* lengths;    // paged: (S,) live tokens incl. the current one
  int MP, H, KVH, npool, page;
  int window;            // 0 = global
  float softcap;         // 0 = none
  float scale;
};

template <int D, typename T>
__global__ void __launch_bounds__(DC_WARPS * 32)
paged_decode_kernel(DecodeArgs p) {
  constexpr int DPL = (D + 31) / 32;       // contiguous channels per lane
  extern __shared__ float red[];           // [DC_WARPS][DC_REP][D + 2]
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int rep = p.H / p.KVH;
  const int r0 = blockIdx.z * DC_REP;
  const int nrep = min(DC_REP, rep - r0);
  const int d0 = lane * DPL;               // this lane's first channel
  const bool lane_on = d0 < D;

  float qr[DC_REP][DPL], acc[DC_REP][DPL], m[DC_REP], l[DC_REP];
#pragma unroll
  for (int r = 0; r < DC_REP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) { qr[r][c] = 0.f; acc[r][c] = 0.f; }
    if (r < nrep && lane_on) {
      const int h = kvh * rep + r0 + r;
      load_row<T, DPL>(q + ((long long)b * p.H + h) * D + d0, qr[r]);
#pragma unroll
      for (int c = 0; c < DPL; ++c) qr[r][c] *= p.scale;
    }
  }

  const int pos = p.lengths[b] - 1;
  const int k_end = min(pos + 1, p.MP * p.page);   // the table's reach
  const int k_lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  const int* table = p.tables + (long long)b * p.MP;

  for (int kpos = k_lo + warp; kpos < k_end; kpos += DC_WARPS) {
    const int pg = table[kpos / p.page];
    const long long base =
        (((long long)kvh * p.npool + pg) * p.page + kpos % p.page) * D + d0;
    float kv[DPL], vv[DPL];
    if (lane_on) {
      load_row<T, DPL>(k + base, kv);
      load_row<T, DPL>(v + base, vv);
    } else {
#pragma unroll
      for (int c = 0; c < DPL; ++c) { kv[c] = 0.f; vv[c] = 0.f; }
    }
#pragma unroll
    for (int r = 0; r < DC_REP; ++r) {
      if (r >= nrep) break;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) part = fmaf(qr[r][c], kv[c], part);
      float s = warp_sum(part);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      const float m_new = fmaxf(m[r], s);
      const float corr = expf(m[r] - m_new);
      const float pv = expf(s - m_new);
      l[r] = l[r] * corr + pv;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pv, vv[c], acc[r][c] * corr);
    }
  }

  // Merge the warps' partial states. A warp that saw no key holds
  // (NEG, 0, 0) and adds nothing; a slot with len == 0 ends as a zero row.
  float* mine = red + (long long)warp * DC_REP * (D + 2);
#pragma unroll
  for (int r = 0; r < DC_REP; ++r) {
    if (lane == 0) {
      mine[r * (D + 2) + D] = m[r];
      mine[r * (D + 2) + D + 1] = l[r];
    }
    if (lane_on) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) mine[r * (D + 2) + d0 + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < nrep * D; e += DC_WARPS * 32) {
    const int r = e / D, d = e % D;
    float mm = NEG;
    for (int w = 0; w < DC_WARPS; ++w)
      mm = fmaxf(mm, red[((long long)w * DC_REP + r) * (D + 2) + D]);
    float ls = 0.f, os = 0.f;
    for (int w = 0; w < DC_WARPS; ++w) {
      const float* part = red + ((long long)w * DC_REP + r) * (D + 2);
      const float f = expf(part[D] - mm);
      ls += part[D + 1] * f;
      os += part[d] * f;
    }
    const int h = kvh * rep + r0 + r;
    st(o + ((long long)b * p.H + h) * D + d, os / fmaxf(ls, 1e-37f));
  }
}

template <int D, typename T>
cudaError_t launch_decode(const DecodeArgs& a, int slots, cudaStream_t s) {
  const size_t smem = sizeof(float) * DC_WARPS * DC_REP * (D + 2);
  void (*kernel)(DecodeArgs) = paged_decode_kernel<D, T>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int rep = a.H / a.KVH;
  dim3 grid(slots, a.KVH, (rep + DC_REP - 1) / DC_REP);
  kernel<<<grid, DC_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode_by_dim(int D, const DecodeArgs& a, int slots, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<16, T>(a, slots, s);
    case 32: return launch_decode<32, T>(a, slots, s);
    case 64: return launch_decode<64, T>(a, slots, s);
    case 128: return launch_decode<128, T>(a, slots, s);
    case 256: return launch_decode<256, T>(a, slots, s);
    default: return cudaErrorInvalidValue;
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
  const bf16* k;       // (B, Tk, KVH, D) contiguous
  const bf16* v;
  bf16* o;             // (B, Tq, H, D)
  int Tq, Tk, H, KVH;
  int q_offset;        // position of query row 0 (Tk - Tq: right-aligned)
  int causal, window;  // window 0 = global
  int stages;          // K/V stages per warp: 1 or 2
  float softcap;       // 0 = none
  float scale;
};

// The K/V loader policy: where key row kpos of (sequence b, kv head kvh)
// lives. Dense rows are strided; a paged loader would look the row's page
// up in a block table here and leave the kernel as it is.
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
  __device__ const bf16* k_row(int kpos) const { return k + kpos * stride; }
  __device__ const bf16* v_row(int kpos) const { return v + kpos * stride; }
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
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Live keys [lo, hi) of the 16-row query tile whose first row sits at
// position q0 (the TPU kernels' block_live rule, per tile).
__host__ __device__ __forceinline__ void flash_tile_keys(
    int q0, int Tk, int causal, int window, int& lo, int& hi) {
  lo = window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1 : 0) : 0;
  hi = Tk;
  if (causal && q0 + FT_ROWS < hi) hi = q0 + FT_ROWS;
}

template <int D, typename Loader>
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

  auto load_tile = [&](int t, int stage) {
    bf16* ks = stage0 + stage * Tl::STAGE;
    bf16* vs = ks + KT * LD;
#pragma unroll
    for (int c = lane; c < KT * D / 8; c += 32) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int kpos = t * KT + r;
      const bool ok = kpos < p.Tk;
      cp_async16(ks + r * LD + col, kv.k_row(ok ? kpos : 0) + col, ok);
      cp_async16(vs + r * LD + col, kv.v_row(ok ? kpos : 0) + col, ok);
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
        mma_bf16(s[j], qf[kk], r[0], r[1]);
        mma_bf16(s[j + 1], qf[kk], r[2], r[3]);
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
      split_pair(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
      split_pair(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
      split_pair(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], ph, r[0], r[1]);
        mma_bf16(acc[n], pl, r[0], r[1]);
        mma_bf16(acc[n + 1], ph, r[2], r[3]);
        mma_bf16(acc[n + 1], pl, r[2], r[3]);
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
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(o.x / ls, o.y / ls);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(o.z / ls, o.w / ls);
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

template <int D>
cudaError_t launch_flash_tc(FlashArgs a, int batch, cudaStream_t s) {
  const int cl = flash_cluster<D>(a, a.stages);
  const dim3 grid(cl, (a.Tq + FT_ROWS - 1) / FT_ROWS, a.H * batch);
  auto kernel = flash_tc_kernel<D, DenseKV>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FlashTile<D>::smem(2));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FT_WARPS * 32);
  cfg.dynamicSmemBytes = FlashTile<D>::smem(a.stages);
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

cudaError_t flash_tc_by_dim(int D, const FlashArgs& a, int batch,
                            cudaStream_t s) {
  switch (D) {
    case 16: return launch_flash_tc<16>(a, batch, s);
    case 32: return launch_flash_tc<32>(a, batch, s);
    case 64: return launch_flash_tc<64>(a, batch, s);
    case 128: return launch_flash_tc<128>(a, batch, s);
    case 256: return launch_flash_tc<256>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Dense decode: the live keys split over blocks, merged in the same launch.
// ---------------------------------------------------------------------------
constexpr int DS_WARPS = 8;
// Keys per block. A sweep of 32, 64, 128 and 256 on the H100, at B=1 S=784
// and at B=4 S=2048 (MQA, D=256), found 64 fastest at both (PERF.md).
constexpr int DS_SPLIT = 64;

struct SplitArgs {
  const void* q;       // (B, 1, H, D) contiguous
  const void* k;       // (B, S, KVH, D) contiguous
  const void* v;
  void* o;             // (B, 1, H, D)
  float* ws;           // [groups][n_splits][REP][D + 2] partials
  int* tickets;        // [groups], zeroed on the stream before the launch
  int H, KVH, S, pos;  // keys <= pos are live
  int window;          // 0 = global
  int n_splits;        // blocks per (sequence, kv head, head group)
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

// The split decode kernel's K/V loader policy: the live keys [lo, hi) of
// sequence b, and where key row kpos of kv head kvh lies, in 16-byte words
// from channel d0. A paged loader would take the range from the sequence's
// length and look the row's page up in a block table here, and leave the
// kernel as it is.
template <typename T>
struct DenseDecodeKV {
  const uint4* k;
  const uint4* v;
  long long row_words;   // 16-byte words between consecutive keys
  int lo, hi;
  __device__ DenseDecodeKV(const SplitArgs& p, int b, int kvh, int D,
                           int d0) {
    const long long row = (long long)p.KVH * D;
    const long long base = (long long)b * p.S * row + (long long)kvh * D + d0;
    k = reinterpret_cast<const uint4*>(static_cast<const T*>(p.k) + base);
    v = reinterpret_cast<const uint4*>(static_cast<const T*>(p.v) + base);
    row_words = row * (long long)sizeof(T) / 16;
    decode_keys(p.S, p.pos, p.window, lo, hi);
  }
  __device__ const uint4* k_row(int kpos) const { return k + kpos * row_words; }
  __device__ const uint4* v_row(int kpos) const { return v + kpos * row_words; }
};

template <typename T, int E>
__device__ __forceinline__ void to_float(const uint4 (&w)[E * sizeof(T) / 16],
                                         float (&out)[E]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < E / 8; ++j) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
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

  const Loader kv(p, b, kvh, D, d0);
  const int k_lo = kv.lo + split * DS_SPLIT;
  const int k_hi = min(kv.hi, k_lo + DS_SPLIT);

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
  if (p.n_splits == 1) {                   // one split: no workspace
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

  // The last block of this (sequence, kv head, head group) merges every
  // split in a fixed order.
  __threadfence();                         // release the partial
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.tickets + gi, 1) == p.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                         // acquire the others'
  const float* ws_g = p.ws + (long long)gi * p.n_splits * part_stride;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < nrep) {                       // head `warp`: max and sum
    float mm = NEG;
    for (int sp = lane; sp < p.n_splits; sp += 32)
      mm = fmaxf(mm, __ldcg(ws_g + sp * part_stride + warp * (D + 2) + D));
    mm = warp_max(mm);
    float ls = 0.f;
    for (int sp = lane; sp < p.n_splits; sp += 32) {
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
    for (int sp = 0; sp < p.n_splits; ++sp) {
      const float* pr = ws_g + sp * part_stride + r * (D + 2);
      os += __ldcg(pr + d) * expf(__ldcg(pr + D) - m_all[r]);
    }
    st(o + ((long long)b * p.H + h0 + r) * D + d, os / l_all[r]);
  }
}

// Query heads per block: every head of a kv head where there are at most 8.
inline int split_rep(int H, int KVH) { return H / KVH <= 4 ? 4 : 8; }

// plan: [0] splits, [1] groups (B * KVH * head groups), [2] query heads per
// block, [3] keys per split, [4] 4-byte words of workspace: the partials
// and then one ticket per group (none for a single split).
void decode_plan(int B, int S, int H, int KVH, int D, int pos, int window,
                 long long* plan) {
  int lo, hi;
  decode_keys(S, pos, window, lo, hi);
  const int live = hi > lo ? hi - lo : 0;
  const int rep_blk = split_rep(H, KVH);
  const int rep = H / KVH;
  plan[0] = live > 0 ? (live + DS_SPLIT - 1) / DS_SPLIT : 1;
  plan[1] = (long long)B * KVH * ((rep + rep_blk - 1) / rep_blk);
  plan[2] = rep_blk;
  plan[3] = DS_SPLIT;
  plan[4] = plan[0] > 1 ? plan[0] * plan[1] * rep_blk * (D + 2LL) + plan[1]
                        : 0;
}

template <int D, typename T, int REP>
cudaError_t launch_split(const SplitArgs& a, cudaStream_t s) {
  using Sh = SplitShape<D, T>;
  const int smem = (int)sizeof(float) * Sh::NG * REP * (D + 2);
  auto kernel = decode_split_kernel<D, T, REP, DenseDecodeKV<T>>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if (a.n_splits > 1) {
    cudaError_t e = cudaMemsetAsync(a.tickets, 0, sizeof(int) * a.groups, s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.n_splits, a.groups);
  kernel<<<grid, DS_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int REP>
cudaError_t split_by_dim(int D, const SplitArgs& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch_split<16, T, REP>(a, s);
    case 32: return launch_split<32, T, REP>(a, s);
    case 64: return launch_split<64, T, REP>(a, s);
    case 128: return launch_split<128, T, REP>(a, s);
    case 256: return launch_split<256, T, REP>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t split_dispatch(int D, int rep_blk, const SplitArgs& a,
                           cudaStream_t s) {
  return rep_blk == 4 ? split_by_dim<T, 4>(D, a, s)
                      : split_by_dim<T, 8>(D, a, s);
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
    int H, int KVH, int D, int causal, int window, float softcap, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    FlashArgs a{};
    a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v); a.o = static_cast<bf16*>(o);
    a.Tq = Tq; a.Tk = Tk; a.H = H; a.KVH = KVH; a.q_offset = Tk - Tq;
    a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
    return (int)flash_tc_by_dim(D, a, B, s);
  }
  PrefillArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.table = nullptr;
  a.kv_tstride = (long long)KVH * D;
  a.kv_bstride = (long long)Tk * KVH * D;
  a.Tq = Tq; a.H = H; a.KVH = KVH;
  a.q_offset = Tk - Tq; a.kv_len = Tk;
  a.causal = causal; a.window = window; a.npool = 0; a.page = 1;
  a.softcap = softcap; a.scale = scale;
  return (int)prefill_by_dim<float, false>(D, a, B, s);
}

extern "C" int paged_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    void* o, int Tq, int start, int H, int KVH, int D, int npool, int page,
    int window, float softcap, float scale, int dtype, void* stream) {
  PrefillArgs a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.o = o; a.table = table;
  a.kv_bstride = 0; a.kv_tstride = 0;
  a.Tq = Tq; a.H = H; a.KVH = KVH;
  a.q_offset = start; a.kv_len = start + Tq;
  a.causal = 1; a.window = window; a.npool = npool; a.page = page;
  a.softcap = softcap; a.scale = scale;
  return (int)prefill_dispatch<true>(dtype, D, a, 1,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* lengths, void* o, int S, int MP, int H, int KVH, int D,
    int npool, int page, int window, float softcap, float scale, int dtype,
    void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.o = o;
  a.tables = tables; a.lengths = lengths;
  a.MP = MP; a.H = H; a.KVH = KVH; a.npool = npool; a.page = page;
  a.window = window; a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)decode_by_dim<__nv_bfloat16>(D, a, S, s);
  return (int)decode_by_dim<float>(D, a, S, s);
}

// The split decode kernel's plan for a call (see decode_plan); launches
// nothing.
extern "C" int decode_attention_plan(int B, int S, int H, int KVH, int D,
                                     int pos, int window, long long* plan) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  decode_plan(B, S, H, KVH, D, pos, window, plan);
  return 0;
}

// ws: the plan's workspace, plan[4] words; its tickets are zeroed on the
// stream before the kernel, so calls on any streams never share them.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KVH, int D, int pos, int window, float softcap, float scale, int dtype,
    void* stream, float* ws) {
  long long plan[5];
  const int err = decode_attention_plan(B, S, H, KVH, D, pos, window, plan);
  if (err) return err;
  SplitArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.ws = ws;
  a.n_splits = (int)plan[0]; a.groups = (int)plan[1];
  a.tickets = reinterpret_cast<int*>(
      ws + (long long)a.n_splits * a.groups * plan[2] * (D + 2));
  a.H = H; a.KVH = KVH; a.S = S; a.pos = pos; a.window = window;
  a.nz = (H / KVH + (int)plan[2] - 1) / (int)plan[2];
  a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)split_dispatch<__nv_bfloat16>(D, (int)plan[2], a, s);
  return (int)split_dispatch<float>(D, (int)plan[2], a, s);
}
