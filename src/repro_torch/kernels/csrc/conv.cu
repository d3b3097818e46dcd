// Conv2D for Hopper as an implicit-im2col GEMM, on every datapath of the
// generator's dtype table: int8 and int16 inputs (int32 accumulator, int8 /
// int16 / int32 out), bf16, fp16 and fp32 inputs (fp32 accumulator, bf16 /
// fp16 / fp32 out).
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
//   - fp32, int16: sgemm.cuh's CUDA-core loop (IEEE FMAs with a blocked
//     sum, which stage 4's K = 4608 needs to stay in the fp32 tolerance; or
//     wrapping int32 multiply-adds: Hopper has no int16 tensor-core MMA).
// Either loop's plan (tile, K splits over the taps, the grid) comes from
// (M, CO, K) alone, as a GEMM's does, its cp.async ring keeps the gather in
// flight, split partials merge through the stream's workspace, and the
// bias and the epilogue of epilogue.cuh (rounding shift, activation,
// saturation; or activation, 2^-shift and rounding) run once per output,
// after the last tap of the last split. Two loaders feed A:
//   - ConvTapsA, the tap gather: each thread decomposes its rows' (n, oh,
//     ow) once per tile and walks its chunk's (kh, kw, ci) forward by one
//     k slab per stage (no division per chunk). A chunk of one tap's
//     channels is one cp.async of 16, 8 or 4 bytes; padding is the copy's
//     zero-fill (the source size 0 where the tap falls outside the image),
//     so no padded image and no patch matrix ever exist in device memory.
//     Where CI's bytes have no 4-byte granule (the stem's CI = 3 in int8,
//     int16, bf16 or fp16) a chunk goes in plain element loads; fp32 takes
//     4-byte copies there.
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

namespace {

// Input codes of conv2d_launch / conv_plan.
enum { IN_I8 = 0, IN_I16 = 1, IN_F32 = 2, IN_BF16 = 3, IN_F16 = 4 };
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

// The tensor-core loop: int8 (ES = 1), bf16 or fp16 (the image as bytes).
template <typename In>
int launch_tc(const Shape& sh, const void* x, const void* w, const void* bias,
              void* out, int out_code, int act, int shift, float out_scale,
              void* workspace, cudaStream_t s) {
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
        0, workspace, s));
  }
  const ConvTapsA<16, 1> al{X,     sh.h,  sh.w,      ci,     sh.oh, sh.ow,
                            sh.kh, sh.kw, sh.stride, sh.pad, m,
                            taps_granule<16, 1>(X, ci)};
  return static_cast<int>(igemm::launch<In, ConvTapsA<16, 1>, false>(
      al, B, sh.co, 0, D, 0, out, code, m, sh.co, k, shift, out_scale, act,
      0, workspace, s));
}

// The CUDA-core loop: fp32 or int16, into OutT.
template <typename In, typename OutT>
int launch_cc(const Shape& sh, const void* x, const void* w, const void* bias,
              void* out, int act, int shift, float out_scale, void* workspace,
              cudaStream_t s) {
  using Acc = typename sgemm::Dp<In>::Acc;
  constexpr int ES = (int)sizeof(In);
  const In* X = static_cast<const In*>(x);
  const In* B = static_cast<const In*>(w);
  const Acc* D = static_cast<const Acc*>(bias);
  OutT* C = static_cast<OutT*>(out);
  const int m = sh.m(), k = sh.k();
  if (sh.rows()) {
    const ConvRowsQ<In> al{{X, sh.ci, m, sh.ci, sgemm::quad_aligned(X, sh.ci)}};
    return static_cast<int>(sgemm::launch<In, OutT, ConvRowsQ<In>, false>(
        al, B, D, C, m, sh.co, k, sh.co, 0, 0, act, shift, out_scale, 0,
        workspace, s));
  }
  using Taps = ConvTapsA<4 * ES, ES>;
  const Taps al{reinterpret_cast<const int8_t*>(X), sh.h, sh.w, sh.ci, sh.oh,
                sh.ow, sh.kh, sh.kw, sh.stride, sh.pad, m,
                taps_granule<4 * ES, ES>(X, sh.ci)};
  return static_cast<int>(sgemm::launch<In, OutT, Taps, false>(
      al, B, D, C, m, sh.co, k, sh.co, 0, 0, act, shift, out_scale, 0,
      workspace, s));
}

template <typename In>
int launch_cc_float(const Shape& sh, const void* x, const void* w,
                    const void* bias, void* out, int out_code, int act,
                    int shift, float out_scale, void* ws, cudaStream_t s) {
  if (out_code == OUT_8_OR_BF16)
    return launch_cc<In, __nv_bfloat16>(sh, x, w, bias, out, act, shift,
                                        out_scale, ws, s);
  if (out_code == OUT_16)
    return launch_cc<In, __half>(sh, x, w, bias, out, act, shift, out_scale,
                                 ws, s);
  return launch_cc<In, float>(sh, x, w, bias, out, act, shift, out_scale, ws,
                              s);
}

template <typename In>
int launch_cc_int(const Shape& sh, const void* x, const void* w,
                  const void* bias, void* out, int out_code, int act,
                  int shift, void* ws, cudaStream_t s) {
  if (out_code == OUT_8_OR_BF16)
    return launch_cc<In, int8_t>(sh, x, w, bias, out, act, shift, 1.f, ws, s);
  if (out_code == OUT_16)
    return launch_cc<In, int16_t>(sh, x, w, bias, out, act, shift, 1.f, ws,
                                  s);
  return launch_cc<In, int>(sh, x, w, bias, out, act, shift, 1.f, ws, s);
}

}  // namespace

// x: contiguous (N, H, W, CI) of in_dtype (IN_*); w: contiguous (KH, KW, CI,
// CO) of the same type; bias: (CO,) of the accumulator type (int32 for
// integer inputs, fp32 for float ones) or null; out: contiguous (N, OH, OW,
// CO) of out_dtype (OUT_* of the accumulator's kind); shift in [0, 31]
// (integer) and out_scale 2^-shift (float); workspace: inputs whose plan
// (conv_plan) splits K, its plan[9] 4-byte words owned by the stream, else
// null.
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias,
                             void* out, int n, int h, int wd, int ci, int co,
                             int kh, int kw, int stride, int pad, int oh,
                             int ow, int in_dtype, int out_dtype, int act,
                             int shift, float out_scale, void* stream,
                             void* workspace) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{n, h, wd, ci, co, kh, kw, stride, pad, oh, ow};
  switch (in_dtype) {
    case IN_I8:
      return launch_tc<int8_t>(sh, x, w, bias, out, out_dtype, act, shift,
                               1.f, workspace, s);
    case IN_BF16:
      return launch_tc<__nv_bfloat16>(sh, x, w, bias, out, out_dtype, act,
                                      shift, out_scale, workspace, s);
    case IN_F16:
      return launch_tc<__half>(sh, x, w, bias, out, out_dtype, act, shift,
                               out_scale, workspace, s);
    case IN_F32:
      return launch_cc_float<float>(sh, x, w, bias, out, out_dtype, act,
                                    shift, out_scale, workspace, s);
    case IN_I16:
      return launch_cc_int<int16_t>(sh, x, w, bias, out, out_dtype, act,
                                    shift, workspace, s);
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
// shared memory bytes, [9] workspace 4-byte words (0 for one split).
extern "C" int conv_plan(int m, int n, int k, int in_dtype,
                         long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == IN_F32 || in_dtype == IN_I16) {
    const sgemm::Plan p =
        in_dtype == IN_F32
            ? sgemm::plan<float>(m, n, k, 0, hgemm::sm_count())
            : sgemm::plan<int16_t>(m, n, k, 0, hgemm::sm_count());
    const long long out[10] = {2,        p.bm,     p.bn,      p.bk,
                               p.splits, p.blocks, p.threads, p.stages,
                               p.smem,   p.ws_words};
    for (int i = 0; i < 10; ++i) plan[i] = out[i];
    return 0;
  }
  const igemm::Plan p =
      igemm::plan_here(m, n, k, 0, in_dtype == IN_I8 ? 1 : 2);
  const long long out[10] = {p.regime, p.bm,     p.bn,      igemm::BK,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words};
  for (int i = 0; i < 10; ++i) plan[i] = out[i];
  return 0;
}
