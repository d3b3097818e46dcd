// Attention kernels for Hopper: flash (fresh prompt), paged prefill
// (continuation chunk), paged decode (one token per slot) and dense decode
// (one token against a contiguous cache, the static reference path).
//
// Replaces, in src/repro/kernels/attention.py:
//   flash_attention          (_attn_kernel)          -> prefill_attn_kernel<PAGED=false>
//   paged_prefill_attention  (_paged_prefill_kernel) -> prefill_attn_kernel<PAGED=true>
//   paged_decode_attention   (_paged_decode_kernel)  -> paged_decode_kernel
//   decode_attention         (_decode_kernel)        -> dense_decode_kernel
//
// All four compute the TPU kernels' online softmax in fp32: scores of the
// scaled query against each key, optional softcap, the causal / window /
// length masks with the -0.7 * FLT_MAX mask constant (a -inf would turn a
// fully masked row into exp(-inf - -inf) = NaN), the running (m, l, acc)
// update, and the finalize acc / max(l, 1e-37). On the TPU the KV axis is
// a sequential grid dimension carrying (m, l, acc) in scratch; here it is a
// loop inside one block, since CUDA blocks run in no order.
//
// What bounds them on the H100, and what the design does about it:
//  * Prefill (flash, paged prefill): operations. Every (query, key) pair
//    costs 4 * D flops; the block keeps a 64-row query tile in shared
//    memory and streams 32-key K/V tiles past it, so each K/V byte is read
//    from device memory once per query tile, not once per query. Tiles
//    that no row of the query tile can see (beyond the causal frontier,
//    before the sliding window, past the live length) are never loaded --
//    the TPU kernels' block_live skip -- so a local layer costs
//    O(T * window), not O(T^2). Scores use CUDA-core fp32 FMAs; moving
//    them onto the tensor cores is later work.
//  * Decode: bytes. One query per head reads every live K/V row once, so
//    the call is bound by the cache read. The block for (slot, kv head)
//    handles its H / KVH query heads together, so K/V are read once per
//    kv head (GQA); its warps split the live keys, each lane owns D / 32
//    contiguous channels (16-byte loads for bf16 at D = 256), and the
//    warps' partial softmax states are merged at the end. Keys before the
//    window or past the length are never read, and pages are found through
//    the block table in device memory (no host sync). Dense decode is the
//    same body with contiguous (B, S, KVH, D) addressing: keys 0..pos are
//    live (pos a host int shared by the batch), and blocks outside
//    [max(0, pos - window + 1), min(pos + 1, S)) are never read.
//
// Head dims 16, 32, 64, 128 and 256 are compiled; inputs are fp32 or bf16
// (accumulation is always fp32, output in the input type).
//
// C interface: flash_attention_launch, paged_prefill_launch,
// paged_decode_launch, decode_attention_launch; each returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

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
// Decode: one block per (slot, kv head, group of up to 4 query heads), over
// a paged pool or a dense cache.
// ---------------------------------------------------------------------------
constexpr int DC_WARPS = 8;
constexpr int DC_REP = 4;       // query heads per block

struct DecodeArgs {
  const void* q;         // (S, 1, H, D) contiguous
  const void* k;         // paged: pool (KVH, NPOOL, PAGE, D); dense: (B, S, KVH, D)
  const void* v;
  void* o;               // (S, 1, H, D)
  const int* tables;     // paged: (S, MP) page ids
  const int* lengths;    // paged: (S,) live tokens incl. the current one
  int MP, H, KVH, npool, page;
  long long kv_bstride, kv_tstride;   // dense K/V strides (elements)
  int S, pos;            // dense: cache length; keys <= pos are live
  int window;            // 0 = global
  float softcap;         // 0 = none
  float scale;
};

template <int D, typename T, bool PAGED>
__device__ __forceinline__ void decode_body(const DecodeArgs& p) {
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

  int pos, k_end;
  if constexpr (PAGED) {
    pos = p.lengths[b] - 1;
    k_end = min(pos + 1, p.MP * p.page);   // the table's reach
  } else {
    pos = p.pos;
    k_end = max(0, min(pos + 1, p.S));     // the cache's end
  }
  const int k_lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  const int* table = PAGED ? p.tables + (long long)b * p.MP : nullptr;

  for (int kpos = k_lo + warp; kpos < k_end; kpos += DC_WARPS) {
    long long base;
    if constexpr (PAGED) {
      const int pg = table[kpos / p.page];
      base = (((long long)kvh * p.npool + pg) * p.page + kpos % p.page) * D + d0;
    } else {
      base = (long long)b * p.kv_bstride + (long long)kpos * p.kv_tstride +
             (long long)kvh * D + d0;
    }
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
__global__ void __launch_bounds__(DC_WARPS * 32)
paged_decode_kernel(DecodeArgs p) { decode_body<D, T, true>(p); }

template <int D, typename T>
__global__ void __launch_bounds__(DC_WARPS * 32)
dense_decode_kernel(DecodeArgs p) { decode_body<D, T, false>(p); }

template <int D, typename T, bool PAGED>
cudaError_t launch_decode(const DecodeArgs& a, int slots, cudaStream_t s) {
  const size_t smem = sizeof(float) * DC_WARPS * DC_REP * (D + 2);
  void (*kernel)(DecodeArgs);
  if constexpr (PAGED) kernel = paged_decode_kernel<D, T>;
  else kernel = dense_decode_kernel<D, T>;
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

template <typename T, bool PAGED>
cudaError_t decode_by_dim(int D, const DecodeArgs& a, int slots, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<16, T, PAGED>(a, slots, s);
    case 32: return launch_decode<32, T, PAGED>(a, slots, s);
    case 64: return launch_decode<64, T, PAGED>(a, slots, s);
    case 128: return launch_decode<128, T, PAGED>(a, slots, s);
    case 256: return launch_decode<256, T, PAGED>(a, slots, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
    int H, int KVH, int D, int causal, int window, float softcap, float scale,
    int dtype, void* stream) {
  PrefillArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.table = nullptr;
  a.kv_tstride = (long long)KVH * D;
  a.kv_bstride = (long long)Tk * KVH * D;
  a.Tq = Tq; a.H = H; a.KVH = KVH;
  a.q_offset = Tk - Tq; a.kv_len = Tk;
  a.causal = causal; a.window = window; a.npool = 0; a.page = 1;
  a.softcap = softcap; a.scale = scale;
  return (int)prefill_dispatch<false>(dtype, D, a, B,
                                      static_cast<cudaStream_t>(stream));
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
  if (dtype == DT_BF16) return (int)decode_by_dim<__nv_bfloat16, true>(D, a, S, s);
  return (int)decode_by_dim<float, true>(D, a, S, s);
}

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KVH, int D, int pos, int window, float softcap, float scale, int dtype,
    void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.tables = nullptr; a.lengths = nullptr;
  a.MP = 0; a.H = H; a.KVH = KVH; a.npool = 0; a.page = 1;
  a.kv_tstride = (long long)KVH * D;
  a.kv_bstride = (long long)S * KVH * D;
  a.S = S; a.pos = pos;
  a.window = window; a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)decode_by_dim<__nv_bfloat16, false>(D, a, B, s);
  return (int)decode_by_dim<float, false>(D, a, B, s);
}
