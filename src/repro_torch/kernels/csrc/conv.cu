// Conv2D for Hopper as an implicit-im2col GEMM, on every datapath of the
// generator's dtype table: int8 and int16 inputs (int32 accumulator, int8 /
// int16 / int32 out), bf16, fp16 and fp32 inputs (fp32 accumulator, bf16 /
// fp16 / fp32 out), and int32 inputs (int32 accumulator) on the CUDA-core
// loop. Every other combination runs one of these into its wide sum and
// datapath.cu's epilogue_any after it (kernels/conv.py).
//
// Replaces: src/repro/kernels/conv.py conv2d_implicit (_conv_kernel). On
// the TPU the padded image block sits in VMEM and each filter tap adds one
// (OH*OW, CI) x (CI, co_tile) product into an output-stationary
// accumulator, the epilogue fused on the last tap. Here the conv is one
// GEMM with M = N*OH*OW output pixels, N = CO and K = KH*KW*CI (taps
// major, channels fastest: the HWIO filter read as a row-major (K, CO)
// matrix), run by one of two main loops in its output-stationary order:
//   - int8, bf16, fp16: igemm.cuh's tensor-core loop (mma.sync s8, or
//     m16n8k16 with fp32 accumulate; 16-bit filters read by
//     ldmatrix.trans);
//   - fp32, int16, int32: sgemm.cuh's CUDA-core loop (IEEE FMAs, or
//     wrapping int32 multiply-adds: Hopper has no int16 or int32
//     tensor-core MMA), with a
//     plan of its own (cc_plan below: 56 x 64 tiles of 7 x 8 micro-tiles,
//     4 k groups, no split longer than 512 k).
// Either loop's plan (tile, K splits over the taps, the grid) comes from
// (M, CO, K) alone, as a GEMM's does, its cp.async ring keeps the gather in
// flight, split partials merge through the stream's workspace, and the
// bias and the epilogue of epilogue.cuh (rounding shift, activation,
// saturation; or activation, 2^-shift and rounding) run once per output,
// after the last tap of the last split. Three loaders feed A:
//   - ConvTapsA, the tap gather: each thread decomposes its rows' (n, oh,
//     ow) once per tile and walks its chunk's (kh, kw, ci) forward by one
//     k slab per stage (no division per chunk). A chunk of one tap's
//     channels is one cp.async of 16, 8 or 4 bytes; padding is the copy's
//     zero-fill (the source size 0 where the tap falls outside the image),
//     so no padded image and no patch matrix ever exist in device memory.
//     Where CI's bytes have no 4-byte granule a chunk goes in plain
//     element loads.
//   - ConvStripA, where a tap's channels are less than one 16-byte copy
//     (the stem's CI = 3 on every datapath): the strips of image a tile
//     reads are staged in shared memory once, by 16-byte copies, and A's
//     chunks are built from there (below), where element loads from
//     device memory, one round trip each, held the stem (PERF.md).
//   - ConvRowsA, for 1x1 filters at stride 1 without padding (32 of
//     ResNet-50's 53 convs): A is the NHWC image read as a row-major
//     (N*H*W, CI) matrix, the loop's matrix loader under its own name (so
//     a profile tells these launches from the GEMM's).
// igemm.cuh counts k in bytes, so a 16-bit image goes to it as bytes (2 a
// value: the gather moves bits); sgemm.cuh counts k in elements.
//
// What bounds it on the H100: ResNet-50's layers at batch 1 do 0.1-0.24
// GOP each against a few hundred KB of image and filter (in fp32 about 100
// MB of filters over the stream): operations at the tensor rate in
// principle (int8 1979 TOP/s, 16-bit 989 TFLOP/s; CUDA cores: fp32 67
// TFLOP/s, int16 about 33 TOP/s), the grid's fill and the pipeline's
// latency in practice (PERF.md).
//
// C interface: conv2d_launch and conv_plan; a launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <algorithm>

#include "igemm.cuh"
#include "sgemm.cuh"

// The block's dynamic shared memory (ConvStripA's strips lie in it, after
// the main loop's own).
extern __shared__ __align__(16) int8_t conv_dyn_smem[];

namespace {

// Input codes of conv2d_launch / conv_plan.
enum { IN_I8 = 0, IN_I16 = 1, IN_F32 = 2, IN_BF16 = 3, IN_F16 = 4, IN_I32 = 5 };
// Output codes: integer accumulators 0 int32, 1 int8, 2 int16; fp32
// accumulators 0 fp32, 1 bf16, 2 fp16.
enum { OUT_32 = 0, OUT_8_OR_BF16 = 1, OUT_16 = 2 };

// ES bytes of a value at p, as bits.
template <int ES>
__device__ __forceinline__ uint32_t bits(const int8_t* p) {
  if constexpr (ES == 1) return static_cast<uint8_t>(*p);
  else if constexpr (ES == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *reinterpret_cast<const uint32_t*>(p);
}

// A(m, k) of the implicit GEMM: m = (n, oh, ow), k = (kh, kw, ci). The loop
// counts k in units of ES bytes (igemm.cuh: bytes, ES = 1, a 16-bit image
// then having 2 CI units a pixel; sgemm.cuh: values, ES = 4 or 2), and a
// load() fills BYTES bytes of shared memory from the image.
template <int BYTES, int ES>
struct ConvTapsA {
  const int8_t* x;  // the NHWC image, as bytes
  int H, W, CI, OH, OW, KH, KW, stride, pad, M;  // CI in units
  int g;  // bytes per copy: 16, 8 or 4 (dividing BYTES and CI's bytes, x
          // aligned), else ES < 4: plain loads of one unit

  struct Row {
    long long base;  // byte offset of pixel (n, ih0, iw0), channel 0
    int ih0, iw0, ok;
  };
  struct Cursor {
    int kh, kw, ci;
  };

  __device__ __forceinline__ Row row(int m) const {
    const int ow = m % OW, t = m / OW;
    const int oh = t % OH, n = t / OH;
    const int ih0 = oh * stride - pad, iw0 = ow * stride - pad;
    return {(((long long)n * H + ih0) * W + iw0) * CI * ES, ih0, iw0, m < M};
  }
  __device__ __forceinline__ Cursor cursor(int k) const {
    const int tap = k / CI;
    return {tap / KW, tap % KW, k - tap * CI};
  }
  __device__ __forceinline__ void advance(Cursor& c, int by) const {
    c.ci += by;
    while (c.ci >= CI) {
      c.ci -= CI;
      if (++c.kw == KW) {
        c.kw = 0;
        ++c.kh;
      }
    }
  }
  // Tap (kh, kw) of row r inside the image and the filter (kh < KH: k < K).
  __device__ __forceinline__ bool inside(const Row& r, const Cursor& c) const {
    const int ih = r.ih0 + c.kh, iw = r.iw0 + c.kw;
    return r.ok && c.kh < KH && ih >= 0 && ih < H && iw >= 0 && iw < W;
  }
  __device__ __forceinline__ const int8_t* at(const Row& r,
                                              const Cursor& c) const {
    return x + r.base + (((long long)c.kh * W + c.kw) * CI + c.ci) * ES;
  }
  __device__ __forceinline__ void load(void* dst, const Row& r,
                                       Cursor c) const {
    if (g < 4) {
      constexpr int PER = 4 / ES;  // units a 4-byte word
      uint32_t w[BYTES / 4] = {};
      for (int e = 0; e < BYTES / ES && c.kh < KH; ++e) {
        if (inside(r, c))
          w[e / PER] |= bits<ES>(at(r, c)) << (8 * ES * (e % PER));
        advance(c, 1);
      }
      if constexpr (BYTES == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      return;
    }
    const uint32_t d = hgemm::smem_u32(dst);
    for (int o = 0; o < BYTES; o += g) {
      const bool in = inside(r, c);
      igemm::cp_async(d + o, in ? at(r, c) : x, g, in ? g : 0);
      advance(c, g / ES);
    }
  }
};

// The strip loader for an image whose taps have less than 16 bytes of
// channels (the stem: CI = 3 in every datapath). For one output pixel and
// one kernel row kh, the KW x CI taps are KW CI consecutive values of the
// NHWC image, and a tile's consecutive pixels of one output row read one
// contiguous strip per kh: ((cnt - 1) stride + KW) CI values for cnt
// pixels. stage() copies those strips, one slot per (output row of the
// tile, kh), into shared memory after the loop's own, by aligned 16-byte
// cp.async copies of the window around each strip (its start need not be
// aligned: a copy keeps the address's residue mod 16, and the readers add
// it back), waits for them, and writes zeros where a strip lies in the
// padding. load() then reads a chunk's taps from shared memory with no
// test but the row and K. Bytes throughout: CIB a pixel, j a tap row's
// byte; the loop's k unit is KU bytes (igemm.cuh 1, sgemm.cuh a value).
template <int ES>
__device__ __forceinline__ uint32_t lds(uint32_t a) {
  uint32_t v;
  if constexpr (ES == 1)
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  else if constexpr (ES == 2)
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(a));
  else
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
template <int ES>
__device__ __forceinline__ void sts_zero(uint32_t a) {
  if constexpr (ES == 1)
    asm volatile("st.shared.u8 [%0], %1;\n" :: "r"(a), "r"(0) : "memory");
  else if constexpr (ES == 2)
    asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(a), "r"(0) : "memory");
  else
    asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(0) : "memory");
}

template <int BYTES, int ES, int KU>
struct ConvStripA {
  const int8_t* x;  // the NHWC image, as bytes
  int H, W, CIB, OH, OW, KH, KW, stride, pad, M;   // CIB: bytes a pixel
  int bm;           // the plan's tile rows: a tile starts at m - m % bm
  int patch, slot;  // the strips' byte offset in shared memory, bytes a slot
  int segs;         // output rows a tile may touch
  int rp;           // an image row's bytes mod 16

  struct Row {
    uint32_t base;  // shared address of the pixel's taps, kh = 0, before
                    // the strip's residue
    int ok, off;    // off: the kh = 0 strip's residue mod 16
  };
  struct Cursor {
    int kh, j;      // kernel row, byte in its KW x CI taps
  };

  __device__ __forceinline__ uint32_t strips() const {
    return hgemm::smem_u32(conv_dyn_smem) + patch;
  }
  // Byte offset in x of pixel (n, ih, iw), channel 0 (iw may be < 0).
  __device__ __forceinline__ long long at(int n, int ih, int iw) const {
    return (((long long)n * H + ih) * W + iw) * CIB;
  }
  // Strip (seg, kh) of the tile at m0: image row ih, its pixels [iwa, iwb)
  // of which [lo, hi) lie in the image; false where the slot is unused.
  __device__ __forceinline__ bool strip(int m0, int seg, int kh, int& n,
                                        int& ih, int& iwa, int& iwb,
                                        int& lo, int& hi) const {
    const int g = m0 / OW + seg;  // output row n * OH + oh
    const int ma = max(m0, g * OW), mb = min(min(m0 + bm, M), (g + 1) * OW);
    if (ma >= mb) return false;
    n = g / OH;
    ih = (g % OH) * stride - pad + kh;
    iwa = (ma - g * OW) * stride - pad;
    iwb = (mb - 1 - g * OW) * stride - pad + KW;
    lo = max(iwa, 0);
    hi = min(iwb, W);
    return true;
  }

  __device__ void stage(int m0) const {
    const int ch = slot / 16;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    for (int it = threadIdx.x; it < segs * KH * ch; it += blockDim.x) {
      const int c = it % ch, kh = (it / ch) % KH, seg = it / (ch * KH);
      int n, ih, iwa, iwb, lo, hi;
      if (!strip(m0, seg, kh, n, ih, iwa, iwb, lo, hi) || ih < 0 ||
          ih >= H || lo >= hi)
        continue;
      const uintptr_t first = (xa + at(n, ih, iwa)) & ~(uintptr_t)15;
      const uintptr_t w0 = (xa + at(n, ih, lo)) & ~(uintptr_t)15;
      const uintptr_t w1 = (xa + at(n, ih, hi) + 15) & ~(uintptr_t)15;
      const uintptr_t src = w0 + 16 * (uintptr_t)c;
      if (src < w1)
        igemm::cp_async(strips() + (seg * KH + kh) * slot +
                            (uint32_t)(src - first),
                        reinterpret_cast<const void*>(src), 16, 16);
    }
    hgemm::cp_async_commit();
    hgemm::cp_async_wait<0>();
    __syncthreads();
    // zeros where a strip lies outside the image: a warp a slot
    const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
    for (int sl = threadIdx.x / 32; sl < segs * KH; sl += warps) {
      const int seg = sl / KH, kh = sl % KH;
      int n, ih, iwa, iwb, lo, hi;
      if (!strip(m0, seg, kh, n, ih, iwa, iwb, lo, hi)) continue;
      const uint32_t q0 = strips() + sl * slot +
                          (uint32_t)((reinterpret_cast<uintptr_t>(x) +
                                      at(n, ih, iwa)) & 15);
      const int all = (iwb - iwa) * CIB;
      const bool out = ih < 0 || ih >= H || lo >= hi;
      const int left = out ? all : (lo - iwa) * CIB;   // bytes from the start
      const int right = out ? all : (hi - iwa) * CIB;  // zeros from here
      for (int b = lane * ES; b < left + all - right; b += 32 * ES)
        sts_zero<ES>(q0 + (b < left ? b : right + b - left));
    }
  }

  __device__ __forceinline__ Row row(int m) const {
    const int m0 = m - m % bm, g0 = m0 / OW, g = m / OW;
    const int ow = m - g * OW, n = g / OH;
    const int ow_a = g == g0 ? m0 - g0 * OW : 0;  // the strip's first pixel
    const int off = (int)((reinterpret_cast<uintptr_t>(x) +
                           at(n, (g % OH) * stride - pad,
                              ow_a * stride - pad)) & 15);
    return {strips() + (g - g0) * KH * slot + (ow - ow_a) * stride * CIB,
            m < M, off};
  }
  __device__ __forceinline__ Cursor cursor(int k) const {
    const int b = k * KU, taps = KW * CIB;
    return {b / taps, b % taps};
  }
  __device__ __forceinline__ void advance(Cursor& c, int by) const {
    const int taps = KW * CIB;
    c.j += by * KU;
    while (c.j >= taps) {
      c.j -= taps;
      ++c.kh;
    }
  }
  __device__ __forceinline__ void load(void* dst, const Row& r,
                                       Cursor c) const {
    constexpr int PER = 4 / ES;  // values a 4-byte word
    const int taps = KW * CIB;
    uint32_t w[BYTES / 4] = {};
#pragma unroll
    for (int e = 0; e < BYTES / ES; ++e) {
      if (r.ok && c.kh < KH)
        w[e / PER] |= lds<ES>(r.base + c.kh * slot +
                              ((r.off + c.kh * rp) & 15) + c.j)
                      << (8 * ES * (e % PER));
      c.j += ES;
      if (c.j == taps) {
        c.j = 0;
        ++c.kh;
      }
    }
    if constexpr (BYTES == 16)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
};

// The image as a row-major (N*H*W, CI) matrix: 1x1, stride 1, no padding.
struct ConvRowsA : igemm::MatrixA {};
template <typename In>
struct ConvRowsQ : sgemm::MatrixA<In> {};

// The copy granule of a gather of CI units of ES bytes, at most BYTES.
template <int BYTES, int ES>
int taps_granule(const void* x, int ci) {
  const int g = std::min(igemm::granule(x, (long long)ci * ES), BYTES);
  return g < 4 ? ES : g;
}

struct Shape {
  int n, h, w, ci, co, kh, kw, stride, pad, oh, ow;
  int m() const { return n * oh * ow; }
  int k() const { return kh * kw * ci; }
  bool rows() const { return kh == 1 && kw == 1 && stride == 1 && pad == 0; }
};

// The strips' shared memory for tiles of bm rows and es-byte values:
// segs x KH slots of `slot` bytes (a strip of a whole tile's pixels, its
// residue and the last window's tail), or 0 where the strip loader does
// not take the image (a tap's channels fill a 16-byte copy, or the strips
// would pass STRIP_SMEM).
constexpr int STRIP_SMEM = 48 * 1024;
struct Strips {
  int segs, slot, bytes;
};
inline Strips strip_geometry(const Shape& sh, int bm, int es) {
  Strips st{0, 0, 0};
  if (sh.rows() || sh.ci * es >= 16) return st;
  st.segs = (bm + sh.ow - 2) / sh.ow + 1;
  const int pixels = (std::min(bm, sh.ow) - 1) * sh.stride + sh.kw;
  st.slot = (pixels * sh.ci * es + 30 + 15) / 16 * 16;
  const long long bytes = (long long)st.segs * sh.kh * st.slot;
  st.bytes = bytes <= STRIP_SMEM ? (int)bytes : 0;
  return st;
}

template <int BYTES, int ES, int KU>
ConvStripA<BYTES, ES, KU> strip_loader(const Shape& sh, const void* x, int m,
                                       int bm, int patch, const Strips& st) {
  const int cib = sh.ci * ES;
  return {static_cast<const int8_t*>(x), sh.h, sh.w, cib, sh.oh, sh.ow,
          sh.kh, sh.kw, sh.stride, sh.pad, m, bm, patch, st.slot, st.segs,
          (int)((long long)sh.w * cib % 16)};
}

// The tensor-core loop: int8 (ES = 1), bf16 or fp16 (the image as bytes).
template <typename In>
int launch_tc(const Shape& sh, const void* x, const void* w, const void* bias,
              void* out, int out_code, int act, int shift, float out_scale,
              void* workspace, cudaStream_t s, int tile, int splits) {
  using Acc = typename igemm::Dp<In>::Acc;
  constexpr int ES = (int)sizeof(In);
  const int8_t* X = static_cast<const int8_t*>(x);
  const In* B = static_cast<const In*>(w);
  const Acc* D = static_cast<const Acc*>(bias);
  const int m = sh.m(), k = sh.k(), ci = sh.ci * ES;   // ci in bytes
  const int code = !igemm::Dp<In>::INT && out_code == OUT_8_OR_BF16
                       ? igemm::OUT_BF16 : out_code;
  if (sh.rows()) {
    const ConvRowsA al{{X, ci, m, ci, igemm::granule(X, ci)}};
    return static_cast<int>(igemm::launch<In, ConvRowsA, false>(
        al, B, sh.co, 0, D, 0, out, code, m, sh.co, k, shift, out_scale, act,
        0, workspace, s, 0, tile, splits));
  }
  igemm::Plan pl;
  if (!igemm::resolve_here(m, sh.co, k, 0, ES, tile, splits, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strips st = strip_geometry(sh, pl.bm, ES);
  if (st.bytes > 0) {
    using Strip = ConvStripA<16, ES, 1>;
    const Strip al = strip_loader<16, ES, 1>(sh, x, m, pl.bm, pl.smem, st);
    return static_cast<int>(igemm::launch<In, Strip, false>(
        al, B, sh.co, 0, D, 0, out, code, m, sh.co, k, shift, out_scale, act,
        0, workspace, s, st.bytes, tile, splits));
  }
  const ConvTapsA<16, 1> al{X,     sh.h,  sh.w,      ci,     sh.oh, sh.ow,
                            sh.kh, sh.kw, sh.stride, sh.pad, m,
                            taps_granule<16, 1>(X, ci)};
  return static_cast<int>(igemm::launch<In, ConvTapsA<16, 1>, false>(
      al, B, sh.co, 0, D, 0, out, code, m, sh.co, k, shift, out_scale, act,
      0, workspace, s, 0, tile, splits));
}

// The CUDA-core loop's plan for the conv (fp32 and int16 alike). One
// shape: 56 x 64 tiles of 7 x 8 micro-tiles (ResNet-50's M = 12544, 3136,
// 784, 196, 49 are 49 times a power of two, so 56-row tiles pad them by
// 0-12.5%, 64 or 128 rows by up to 30%; 64 columns, where CO = 64 half a
// 128-column tile was zeros) and KG = 4 k groups (256 threads: 8 warps on
// a tile; at 128 registers a thread, two tiles share an SM). On the H100
// it beat 112 x 64 and 56 x 128 tiles of 2 k groups at every layer of
// the stream, and a ring of 6 or 8 slices was no faster than 4 (PERF.md).
// K splits over the taps, a power of two (an uneven split measured slower
// than the power of two below it):
//   - every split walks at most MAX_CHAIN k (fp32: one chain of IEEE FMAs
//     a group and split, the partials added in split order, in place of
//     the GEMM's blocked sum, whose second set of accumulators held the
//     registers the k groups need);
//   - the splits minimize L (k steps a split + CC_FILL) / rate(L) +
//     CC_TAIL [s > 1] + CC_MERGE (s - 1), in k steps: L the blocks on the
//     busiest SM, rate 1 for one block and CC_PAIR for two sharing it
//     (their 16 warps hide more latency), CC_TAIL the ticket's and the
//     merge's round trips: fitted to a sweep of the splits at the
//     stream's layers on the H100, where it picks the fastest count at
//     each (tools/conv_phases.py --splits).
constexpr int CC_TY = 8, CC_TX = 8, CC_KG = 4;
constexpr int MAX_CHAIN = 512, CC_MAX_SPLITS = 32;
constexpr double CC_FILL = 2.0, CC_TAIL = 3.0, CC_MERGE = 0.2;
constexpr double CC_PAIR = 1.2;
template <typename In>
using CcShape = sgemm::Shape<In, 7, CC_TY, CC_TX, CC_KG, false>;

// The plan with s splits.
template <typename In>
sgemm::Plan cc_plan_of(int m, int n, int k, int s) {
  using hgemm::ceil_div;
  using Sh = CcShape<In>;
  sgemm::Plan p{};
  p.bm = Sh::BM;
  p.bn = Sh::BN;
  p.bk = sgemm::BK;
  p.threads = Sh::T;
  p.stages = sgemm::STAGES;
  p.smem = Sh::SMEM;
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, p.bn);
  p.ksteps = ceil_div(k, sgemm::BK);
  p.splits = s;
  p.blocks = (long long)p.tiles_m * p.tiles_n * s;
  p.ws_words = s > 1 ? hgemm::MAX_TICKETS + p.blocks * p.bm * p.bn : 0;
  return p;
}

template <typename In>
sgemm::Plan cc_plan(int m, int n, int k, int sms) {
  using hgemm::ceil_div;
  const sgemm::Plan one = cc_plan_of<In>(m, n, k, 1);
  const long long tiles = (long long)one.tiles_m * one.tiles_n;
  const int least = ceil_div(one.ksteps, MAX_CHAIN / sgemm::BK);
  // powers of two up to CC_MAX_SPLITS, at least 2 k steps a split; one
  // split past the workspace's tickets
  const int most = tiles > hgemm::MAX_TICKETS
                       ? 1 : std::min(CC_MAX_SPLITS, one.ksteps / 2);
  int best_s = 1;
  double best = -1.0;
  for (int s = 1; s <= std::max(most, 1); s *= 2) {
    if (s < least && 2 * s <= most) continue;   // its chains pass MAX_CHAIN
    const long long per_sm = (tiles * s + sms - 1) / sms;
    const double rate = per_sm > 1 ? CC_PAIR : 1.0;
    const double cost =
        per_sm * (ceil_div(one.ksteps, s) + CC_FILL) / rate +
        (s > 1 ? CC_TAIL : 0.0) + CC_MERGE * (s - 1);
    if (best < 0 || cost < best) {
      best = cost;
      best_s = s;
    }
  }
  return cc_plan_of<In>(m, n, k, best_s);
}

// The conv's plan with its K splits chosen by the caller (its one tile
// shape: tile code 1); false where the kernel cannot run it: more splits
// than k steps or than a tile merges (CC_MAX_SPLITS), or split partials
// past the tickets.
template <typename In>
bool cc_resolve(int m, int n, int k, int tile, int splits, sgemm::Plan& p) {
  if (tile == 0 && splits == 0) {
    p = cc_plan<In>(m, n, k, hgemm::sm_count());
    return true;
  }
  p = cc_plan_of<In>(m, n, k, splits > 0 ? splits : 1);
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  return tile == 1 && splits >= 1 && splits <= CC_MAX_SPLITS &&
         splits <= (p.ksteps > 1 ? p.ksteps : 1) &&
         (splits == 1 || tiles <= hgemm::MAX_TICKETS);
}

template <typename In, typename ALoad>
int launch_cc_shape(const sgemm::Plan& pl, const sgemm::Args<In>& a,
                    const ALoad& al, int smem, cudaStream_t s) {
  return static_cast<int>(
      sgemm::launch_shape<In, 7, CC_TY, CC_TX, CC_KG, false, false,
                          sgemm::AnyOut>(a, al, pl.blocks, smem, s));
}

// The CUDA-core loop: fp32 or int16, into the output of out_code.
template <typename In>
int launch_cc(const Shape& sh, const void* x, const void* w, const void* bias,
              void* out, int out_code, int act, int shift, float out_scale,
              void* workspace, cudaStream_t s, int tile, int splits) {
  using Acc = typename sgemm::Dp<In>::Acc;
  constexpr int ES = (int)sizeof(In);
  const In* X = static_cast<const In*>(x);
  const int m = sh.m(), k = sh.k();
  sgemm::Plan pl;
  if (!cc_resolve<In>(m, sh.co, k, tile, splits, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.splits > 1 && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const sgemm::Args<In> a = sgemm::make_args<In>(
      pl, static_cast<const In*>(w), static_cast<const Acc*>(bias), out,
      out_code, m, sh.co, k, sh.co, 0, act, shift, out_scale, 0, workspace);
  if (sh.rows()) {
    const ConvRowsQ<In> al{{X, sh.ci, m, sh.ci, sgemm::quad_aligned(X, sh.ci)}};
    return launch_cc_shape<In>(pl, a, al, pl.smem, s);
  }
  const Strips st = strip_geometry(sh, pl.bm, ES);
  if (st.bytes > 0)
    return launch_cc_shape<In>(
        pl, a, strip_loader<4 * ES, ES, ES>(sh, x, m, pl.bm, pl.smem, st),
        pl.smem + st.bytes, s);
  using Taps = ConvTapsA<4 * ES, ES>;
  const Taps al{reinterpret_cast<const int8_t*>(X), sh.h, sh.w, sh.ci, sh.oh,
                sh.ow, sh.kh, sh.kw, sh.stride, sh.pad, m,
                taps_granule<4 * ES, ES>(X, sh.ci)};
  return launch_cc_shape<In>(pl, a, al, pl.smem, s);
}

}  // namespace

// x: contiguous (N, H, W, CI) of in_dtype (IN_*); w: contiguous (KH, KW, CI,
// CO) of the same type; bias: (CO,) of the accumulator type (int32 for
// integer inputs, fp32 for float ones) or null; out: contiguous (N, OH, OW,
// CO) of out_dtype (OUT_* of the accumulator's kind); shift in [0, 31]
// (integer) and out_scale 2^-shift (float); workspace: inputs whose plan
// (conv_plan) splits K, its plan[9] 4-byte words owned by the stream, else
// null; tile, splits: the caller's plan (conv_plan's tile codes), or 0, 0
// for the call's own.
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias,
                             void* out, int n, int h, int wd, int ci, int co,
                             int kh, int kw, int stride, int pad, int oh,
                             int ow, int in_dtype, int out_dtype, int act,
                             int shift, float out_scale, void* stream,
                             void* workspace, int tile, int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{n, h, wd, ci, co, kh, kw, stride, pad, oh, ow};
  switch (in_dtype) {
    case IN_I8:
      return launch_tc<int8_t>(sh, x, w, bias, out, out_dtype, act, shift,
                               1.f, workspace, s, tile, splits);
    case IN_BF16:
      return launch_tc<__nv_bfloat16>(sh, x, w, bias, out, out_dtype, act,
                                      shift, out_scale, workspace, s, tile,
                                      splits);
    case IN_F16:
      return launch_tc<__half>(sh, x, w, bias, out, out_dtype, act, shift,
                               out_scale, workspace, s, tile, splits);
    case IN_F32:
      return launch_cc<float>(sh, x, w, bias, out, out_dtype, act, shift,
                              out_scale, workspace, s, tile, splits);
    case IN_I16:
      return launch_cc<int16_t>(sh, x, w, bias, out, out_dtype, act, shift,
                                1.f, workspace, s, tile, splits);
    case IN_I32:
      return launch_cc<int>(sh, x, w, bias, out, out_dtype, act, shift, 1.f,
                            workspace, s, tile, splits);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan of the conv kernel that in_dtype runs for its implicit GEMM (M,
// N, K) = (N*OH*OW, CO, KH*KW*CI) on the current device; launches
// nothing. plan: [0] regime (0 skinny 16 x 64, 1 square 64 x 64: the
// tensor-core loop; 2 the CUDA-core loop), [1] block rows, [2] block
// columns, [3] k bytes (tensor cores) or values (CUDA cores) per stage,
// [4] K splits, [5] blocks, [6] threads per block, [7] ring stages, [8]
// shared memory bytes, [9] workspace 4-byte words (0 for one split), [10]
// the tile code. tile, splits: the caller's plan, or 0, 0 for the call's
// own; tile codes: the tensor-core loop 1 skinny, 2 square (any M); the
// CUDA-core loop 1 (its one shape); a plan the kernel cannot run is
// cudaErrorInvalidValue.
extern "C" int conv_plan(int m, int n, int k, int in_dtype, int tile,
                         int splits, long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == IN_F32 || in_dtype == IN_I16 || in_dtype == IN_I32) {
    sgemm::Plan p;
    const bool ok = in_dtype == IN_F32
                        ? cc_resolve<float>(m, n, k, tile, splits, p)
                    : in_dtype == IN_I16
                        ? cc_resolve<int16_t>(m, n, k, tile, splits, p)
                        : cc_resolve<int>(m, n, k, tile, splits, p);
    if (!ok) return bad;
    const long long out[11] = {2,        p.bm,     p.bn,      p.bk,
                               p.splits, p.blocks, p.threads, p.stages,
                               p.smem,   p.ws_words, 1};
    for (int i = 0; i < 11; ++i) plan[i] = out[i];
    return 0;
  }
  igemm::Plan p;
  if (!igemm::resolve_here(m, n, k, 0, in_dtype == IN_I8 ? 1 : 2, tile,
                           splits, p))
    return bad;
  const long long out[11] = {p.regime, p.bm,     p.bn,      igemm::BK,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, igemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}
