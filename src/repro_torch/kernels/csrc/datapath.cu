// The engine's remaining datapaths for Hopper: every (input, accumulator,
// output) combination the JAX package's gemm_ref accepts beyond the fifteen
// that gemm.cu, gemm16.cu and conv.cu run in one launch.
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (:81, pallas_call :105),
// gemm_ws (:160, pallas_call :184) and accumulator_epilogue (:230,
// pallas_call :246), and in src/repro/kernels/conv.py conv2d_implicit (:88,
// pallas_call :140), on the combinations those kernels take through
// dot_general's preferred_element_type and epilogue.apply.
//
// XLA's CPU computes dot_general(a, b, preferred_element_type=P) in one
// dtype D (kernels/ref.py product_dtypes): both inputs converted to P where
// their dtypes differ, else the higher of the inputs' dtype and P in XLA's
// precision order (int8 < int16 < int32 < fp16 < bf16 < fp32), the sum
// converted to P. The 171 combinations collapse onto four mechanisms:
//   (a) the product on an existing main loop, chosen by D: bf16 / fp16 on
//       hgemm.cuh, fp32 on sgemm.cuh, int8 / int16 inputs on igemm.cuh
//       (an int8 or int16 sum wrapped to 8 or 16 bits is the int32 sum
//       wrapped, so those loops serve every integer D as wide as the
//       inputs), each writing its wide sum (fp32 or int32);
//   (b) int32 inputs: sgemm.cuh's loop on int32 multiply-adds modulo 2^32
//       (gemm_s32_launch here, conv.cu's IN_I32), sgemm's plan;
//   (c) epilogue_any: the wide sum rounded (floats) or wrapped (integers)
//       to D, converted to P, the bias converted to P and added there,
//       then the plain version's epilogue and cast (epilogue.cuh any_*);
//       accumulator_epilogue runs it on every accumulator dtype;
//   (d) convert: inputs whose dtype is not the main loop's (mixed input
//       dtypes, an int8 input beside an int16 one, a float input of an
//       integer D) converted by XLA's rules first, strided views read
//       through their strides.
// A combination runs as (d) where it needs it, then (a) or (b), then (c):
// two to four launches, each counted. Nothing here is a library call.
//
// What bounds them: (c) and (d) are elementwise, bytes (one read and one
// write of each value at 3.35 TB/s); (b) the INT32 multiply-add rate of the
// CUDA cores (half the fp32 FMA rate).
//
// C interface: convert_launch, convert_plan, epilogue_any_launch,
// gemm_s32_launch, gemm_s32_plan; each launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "sgemm.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  const long long most = 132LL * 16;
  return (unsigned)(b < 1 ? 1 : b < most ? b : most);
}

// ---------------------------------------------------------------------------
// convert: dst (contiguous) = XLA's convert of a strided view, one kernel
// per (source, destination) dtype pair, the pair's scalar step
// epi::any_cast (any_convert with its branches folded at compile time).
//
// The view is rows: s0 * s1 * s2 of them at strides t0..t2, each of len
// values along the innermost axis at stride t3. A row is cut into items of
// `group` lanes (a power of two up to a warp), each lane holding `units`
// units in flight: 16 bytes of the source where the innermost axis is
// packed (t3 == 1: 16 int8, 8 of a 16-bit type, 4 of a 32-bit one),
// single values otherwise. Paths (convert_geom):
//   packed  one row, the whole view contiguous: 16-byte loads, stores of
//           the unit's converted bytes (16-byte words, or one 4- or 8-byte
//           store), a scalar head up to the first aligned output and a
//           scalar tail. Where the source's units do not start on 16 bytes
//           (a view some values into its buffer: `shift` bytes past), each
//           unit is cut from the two aligned 16-byte words it spans by
//           funnel shifts (shift16), so loads and stores stay aligned;
//   rows    the innermost axis packed, rows at any stride (a model's views
//           into its fused projection, the KV pools' slices): the same
//           path in each row, its head, shift and tail per row;
//   general the rest: each lane walks its values along the row at stride
//           t3, `units` loads in flight.
// An item finds its row with two divisions; nothing divides per value.
// Index math is 32-bit unless the items pass 2^31 (wide); a row holds at
// most 2^31 - 1 values.
// ---------------------------------------------------------------------------
constexpr int CV_THREADS = 256;
constexpr int CV_VECS = 4;        // 16-byte vectors a lane keeps in flight
constexpr int CV_SCALARS = 8;     // strided values a lane keeps in flight
constexpr long long CV_INT_MAX = 2147483647LL;
enum { CV_PACKED = 0, CV_ROWS = 1, CV_GENERAL = 2 };

struct CvArgs {
  const void* src;
  void* dst;
  long long s1, s2;               // the rows' middle and inner outer dims
  long long t0, t1, t2, t3;       // element strides
  long long rows;
  int len, group, segs;           // values a row; lanes an item; items a row
};

struct CvGeom {
  int path, blocks, group, units, vec, segs, shift, wide;
  long long rows;
  int len;
};

// The launch's geometry (convert_plan reports it): false where the call
// is refused (a dtype code out of range, equal dtypes, an empty view, a
// row of 2^31 values or more). src_off: the source's address modulo 16
// (the output is 16-byte aligned, so the first row's head is empty and its
// units' shift is src_off).
inline bool convert_geom(int sdt, int ddt, const long long* s,
                         const long long* t, long long src_off, int sms,
                         CvGeom& g) {
  static const int width[6] = {1, 2, 4, 2, 2, 4};
  if (sdt < 0 || sdt > 5 || ddt < 0 || ddt > 5 || sdt == ddt || sms < 1)
    return false;
  for (int i = 0; i < 4; ++i)
    if (s[i] < 1) return false;
  const long long rows = s[0] * s[1] * s[2], len = s[3];
  if (len > CV_INT_MAX) return false;
  const int ws = width[sdt];
  const bool vec = t[3] == 1 || len == 1;
  g.vec = vec ? 16 / ws : 1;
  g.path = !vec ? CV_GENERAL : rows == 1 ? CV_PACKED : CV_ROWS;
  g.units = vec ? CV_VECS : CV_SCALARS;
  const long long per_row = (len + g.vec - 1) / g.vec;    // units, at most
  const long long lanes = (per_row + g.units - 1) / g.units;
  g.group = 1;
  while (g.group < lanes && g.group < 32) g.group <<= 1;
  const long long seg = (long long)g.group * g.units;
  g.segs = (int)((per_row + seg - 1) / seg);
  g.rows = rows;
  g.len = (int)len;
  const long long items = rows * g.segs;
  g.wide = items > CV_INT_MAX;
  const long long want = (items * g.group + CV_THREADS - 1) / CV_THREADS;
  g.blocks = (int)(want < 4LL * sms ? want : 4LL * sms);
  g.shift = vec ? (int)(src_off % 16) : 0;
  return true;
}

// The 16 bytes at byte `m` (0 < m < 16) of the 32 in a, b.
__device__ __forceinline__ uint4 shift16(uint4 a, uint4 b, unsigned m) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const unsigned q = m >> 2, s = (m & 3u) * 8u;
  unsigned v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(v[0], v[1], s),
                    __funnelshift_r(v[1], v[2], s),
                    __funnelshift_r(v[2], v[3], s),
                    __funnelshift_r(v[3], v[4], s));
}

template <int S, int D, bool VEC, typename I>
__device__ __forceinline__ void convert_items(const CvArgs& p) {
  using ST = typename epi::AnyT<S>::T;
  using DT = typename epi::AnyT<D>::T;
  constexpr int V = VEC ? 16 / (int)sizeof(ST) : 1;
  constexpr int U = VEC ? CV_VECS : CV_SCALARS;
  constexpr int OB = V * (int)sizeof(DT);     // bytes a vector writes
  constexpr int OW = OB < 16 ? OB : 16;       // bytes a store
  const int G = p.group;
  const int lane = threadIdx.x & (G - 1);
  const I per_block = CV_THREADS / G;
  const I stride = (I)gridDim.x * per_block;
  const I items = (I)p.rows * (I)p.segs;
  for (I item = (I)blockIdx.x * per_block + (I)(threadIdx.x / G);
       item < items; item += stride) {
    const I r = item / (I)p.segs;
    const int sg = (int)(item - r * (I)p.segs);
    const I r1 = r / (I)p.s2, i2 = r - r1 * (I)p.s2;
    const I i0 = r1 / (I)p.s1, i1 = r1 - i0 * (I)p.s1;
    const ST* sp = static_cast<const ST*>(p.src) + (long long)i0 * p.t0 +
                   (long long)i1 * p.t1 + (long long)i2 * p.t2;
    DT* dp = static_cast<DT*>(p.dst) + (long long)r * p.len;
    const int u0 = sg * G * U + lane;
    if constexpr (VEC) {
      // the head: values up to the row's first output aligned to a store
      const unsigned dmis = (unsigned)(reinterpret_cast<uintptr_t>(dp) &
                                       (uintptr_t)(OW - 1));
      const int head =
          min(p.len, (int)(((OW - dmis) & (OW - 1)) / (unsigned)sizeof(DT)));
      const int runs = (p.len - head) / V;
      const ST* sv = sp + head;
      DT* dv = dp + head;
      const unsigned m = (unsigned)(reinterpret_cast<uintptr_t>(sv) & 15u);
      const uint4* base = reinterpret_cast<const uint4*>(
          reinterpret_cast<uintptr_t>(sv) - m);
      uint4 in[U];
      if (m == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = u0 + u * G;
          if (j < runs) in[u] = __ldg(base + j);
        }
      } else {
        // unit j spans the aligned words j and j + 1; the second holds a
        // byte of the unit, so it lies inside the source's allocation
        uint4 hi[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = u0 + u * G;
          if (j < runs) {
            in[u] = __ldg(base + j);
            hi[u] = __ldg(base + j + 1);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u0 + u * G < runs) in[u] = shift16(in[u], hi[u], m);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = u0 + u * G;
        if (j >= runs) break;
        const ST* e = reinterpret_cast<const ST*>(&in[u]);
        uint4 ob[(OB + 15) / 16];
        DT* o = reinterpret_cast<DT*>(ob);
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = epi::any_cast<S, D>(e[k]);
        DT* d = dv + j * V;
        if constexpr (OB >= 16) {
#pragma unroll
          for (int w = 0; w < OB / 16; ++w)
            reinterpret_cast<uint4*>(d)[w] = ob[w];
        } else if constexpr (OB == 8) {
          *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(ob);
        } else {
          *reinterpret_cast<unsigned*>(d) =
              *reinterpret_cast<const unsigned*>(ob);
        }
      }
      if (sg == 0) {
        for (int e = lane; e < head; e += G)
          dp[e] = epi::any_cast<S, D>(sp[e]);
        for (int e = head + runs * V + lane; e < p.len; e += G)
          dp[e] = epi::any_cast<S, D>(sp[e]);
      }
    } else {
      ST v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = u0 + u * G;
        if (j < p.len) v[u] = sp[(long long)j * p.t3];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = u0 + u * G;
        if (j < p.len) dp[j] = epi::any_cast<S, D>(v[u]);
      }
    }
  }
}

template <int S, int D, bool VEC>
__global__ void __launch_bounds__(CV_THREADS)
convert_kernel(CvArgs p, int wide) {
  if (wide)
    convert_items<S, D, VEC, long long>(p);
  else
    convert_items<S, D, VEC, int>(p);
}

template <int S, int D>
cudaError_t convert_pair(const CvGeom& g, const CvArgs& a, cudaStream_t st) {
  if constexpr (S == D) {
    return cudaErrorInvalidValue;
  } else {
    if (g.path == CV_GENERAL)
      convert_kernel<S, D, false><<<g.blocks, CV_THREADS, 0, st>>>(a, g.wide);
    else
      convert_kernel<S, D, true><<<g.blocks, CV_THREADS, 0, st>>>(a, g.wide);
    return cudaGetLastError();
  }
}

template <int S>
cudaError_t convert_from(int ddt, const CvGeom& g, const CvArgs& a,
                         cudaStream_t st) {
  switch (ddt) {
    case 0: return convert_pair<S, 0>(g, a, st);
    case 1: return convert_pair<S, 1>(g, a, st);
    case 2: return convert_pair<S, 2>(g, a, st);
    case 3: return convert_pair<S, 3>(g, a, st);
    case 4: return convert_pair<S, 4>(g, a, st);
    default: return convert_pair<S, 5>(g, a, st);
  }
}

// C = epilogue(convert(wrap_or_round(W, D), P) + convert(bias, P)) over an
// (M, N) row-major W of dtype wdt; bias: a row (ldd 0) or (M, N) at row
// stride ldd of dtype bdt, or null.
__global__ void __launch_bounds__(THREADS)
epilogue_any_kernel(const void* w, int wdt, int ddt, int adt, const void* bias,
                    int bdt, long long ldd, void* c, int odt, long long n_cols,
                    long long count, int act, int shift, float out_scale) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < count; i += (long long)gridDim.x * THREADS) {
    epi::AnyVal v = epi::any_convert(wdt, ddt, epi::any_load(w, i, wdt));
    v = epi::any_convert(ddt, adt, v);
    if (bias != nullptr) {
      const long long row = i / n_cols, col = i - row * n_cols;
      const epi::AnyVal b = epi::any_convert(
          bdt, adt, epi::any_load(bias, row * ldd + col, bdt));
      v = epi::any_add(adt, v, b);
    }
    epi::any_store(c, i, odt,
                   epi::any_epilogue(adt, odt, v, shift, act, out_scale));
  }
}

}  // namespace

// dst (contiguous, dtype ddt) = XLA's convert of src (dtype sdt) read as a
// 4-D view of sizes (s0, s1, s2, s3) and element strides (t0..t3); dtype
// codes 0 int8, 1 int16, 2 int32, 3 bf16, 4 fp16, 5 fp32. The path is
// convert_geom's (the caller coalesces the view first, kernels/datapath.py).
extern "C" int convert_launch(const void* src, int sdt, void* dst, int ddt,
                              long long s0, long long s1, long long s2,
                              long long s3, long long t0, long long t1,
                              long long t2, long long t3, void* stream) {
  const long long s[4] = {s0, s1, s2, s3}, t[4] = {t0, t1, t2, t3};
  if (s0 * s1 * s2 * s3 == 0) return 0;
  CvGeom g;
  if (!convert_geom(sdt, ddt, s, t,
                    (long long)(reinterpret_cast<uintptr_t>(src) & 15u),
                    hgemm::sm_count(), g))
    return static_cast<int>(cudaErrorInvalidValue);
  const CvArgs a{src, dst, s1, s2, t0, t1, t2, t3, g.rows, g.len, g.group,
                 g.segs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sdt) {
    case 0: return static_cast<int>(convert_from<0>(ddt, g, a, st));
    case 1: return static_cast<int>(convert_from<1>(ddt, g, a, st));
    case 2: return static_cast<int>(convert_from<2>(ddt, g, a, st));
    case 3: return static_cast<int>(convert_from<3>(ddt, g, a, st));
    case 4: return static_cast<int>(convert_from<4>(ddt, g, a, st));
    default: return static_cast<int>(convert_from<5>(ddt, g, a, st));
  }
}

// The launch convert_launch makes for this view (src_off: the source's
// address modulo 16); launches nothing. plan: [0] path (0 packed, 1 rows,
// 2 general), [1] blocks, [2] threads, [3] lanes an item, [4] units a lane
// an item, [5] values a unit, [6] rows, [7] values a row, [8] items a row,
// [9] the first row's units' bytes past 16 (shifted loads where not 0),
// [10] 64-bit index math.
extern "C" int convert_plan(int sdt, int ddt, long long s0, long long s1,
                            long long s2, long long s3, long long t0,
                            long long t1, long long t2, long long t3,
                            long long src_off, long long* plan) {
  const long long s[4] = {s0, s1, s2, s3}, t[4] = {t0, t1, t2, t3};
  CvGeom g;
  if (!convert_geom(sdt, ddt, s, t, src_off, hgemm::sm_count(), g))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out[11] = {g.path,  g.blocks, CV_THREADS, g.group,
                             g.units, g.vec,    g.rows,     g.len,
                             g.segs,  g.shift,  g.wide};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}

// c (contiguous (count / n_cols, n_cols), dtype odt) = the generic
// epilogue of w (same shape, dtype wdt): w rounded or wrapped to ddt,
// converted to the accumulator adt, + the bias (dtype bdt: a row where ldd
// is 0, else row stride ldd; null: none) in adt, then shift (integer
// accumulators: in [0, 31]; float: out_scale = 2^-shift) and act.
extern "C" int epilogue_any_launch(const void* w, int wdt, int ddt, int adt,
                                   const void* bias, int bdt, long long ldd,
                                   void* c, int odt, long long n_cols,
                                   long long count, int act, int shift,
                                   float out_scale, void* stream) {
  if (count <= 0) return 0;
  epilogue_any_kernel<<<blocks_for(count), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      w, wdt, ddt, adt, bias, bdt, ldd, c, odt, n_cols > 0 ? n_cols : 1,
      count, act, shift, out_scale);
  return static_cast<int>(cudaGetLastError());
}

// int32 inputs: a (M, K) at row stride lda; b (K, N) read as b[k * ldb +
// n], or b[n * ldb + k] when b_trans; d: an int32 bias, row stride ldd (0
// broadcasts one row), or null; c contiguous (M, N): int32 (out_dtype 0),
// int8 (1) or int16 (2), the sums wrapping modulo 2^32; workspace: calls
// whose plan (gemm_s32_plan) splits K, plan[9] 4-byte words owned by the
// stream, else null; tile, splits: the caller's plan (sgemm's tile codes 1,
// 2), or 0, 0 for the call's own.
extern "C" int gemm_s32_launch(const void* a, const void* b, const void* d,
                               void* c, int m, int n, int k, long long lda,
                               long long ldb, int b_trans, long long ldd,
                               int out_dtype, int act, int shift, int ws,
                               void* stream, void* workspace, int tile,
                               int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* A = static_cast<const int*>(a);
  const int* B = static_cast<const int*>(b);
  const int* D = static_cast<const int*>(d);
  if (out_dtype == 1)
    return static_cast<int>(sgemm::launch_gemm<int, int8_t>(
        A, B, D, static_cast<int8_t*>(c), m, n, k, lda, ldb, b_trans, ldd,
        act, shift, 1.f, ws, workspace, s, tile, splits));
  if (out_dtype == 2)
    return static_cast<int>(sgemm::launch_gemm<int, int16_t>(
        A, B, D, static_cast<int16_t*>(c), m, n, k, lda, ldb, b_trans, ldd,
        act, shift, 1.f, ws, workspace, s, tile, splits));
  return static_cast<int>(sgemm::launch_gemm<int, int>(
      A, B, D, static_cast<int*>(c), m, n, k, lda, ldb, b_trans, ldd, act,
      shift, 1.f, ws, workspace, s, tile, splits));
}

// The int32 kernel's plan, as gemm.cu's gemm_plan reports one (plan[0]
// regime 2, the CUDA cores).
extern "C" int gemm_s32_plan(int m, int n, int k, int b_trans, int tile,
                             int splits, long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  sgemm::Plan p;
  if (!sgemm::resolve<int>(m, n, k, b_trans, hgemm::sm_count(), tile, splits,
                           p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out[11] = {2,        p.bm,     p.bn,      p.bk,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, sgemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}
