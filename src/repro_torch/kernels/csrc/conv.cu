// Conv2D for Hopper as an implicit-im2col GEMM on the int8 tensor cores.
//
// Replaces: src/repro/kernels/conv.py conv2d_implicit (_conv_kernel). On
// the TPU the padded image block sits in VMEM and each filter tap adds one
// (OH*OW, CI) x (CI, co_tile) product into an output-stationary
// accumulator, the epilogue fused on the last tap. Here the conv is one
// GEMM with M = N*OH*OW output pixels, N = CO and K = KH*KW*CI (taps
// major, channels fastest: the HWIO filter read as a row-major (K, CO)
// matrix), run by the int8 main loop of igemm.cuh in its output-stationary
// order: its plan (tile, K splits over the taps, the grid) comes from (M,
// CO, K) alone, as a GEMM's does, its cp.async ring keeps the gather in
// flight, and the int32 bias and the epilogue of epilogue.cuh (rounding
// shift, activation, saturation) run once per output, after the last tap
// of the last split. Two loaders feed A:
//   - ConvTapsA, the tap gather: each thread decomposes its rows' (n, oh,
//     ow) once per tile and walks its chunk's (kh, kw, ci) forward by one
//     k slab per stage (no division per chunk). A 16-byte chunk of one
//     tap's channels is one cp.async; padding is the copy's zero-fill (the
//     source size 0 where the tap falls outside the image), so no padded
//     image and no patch matrix ever exist in device memory. Where CI is
//     not a multiple of 16 the chunk goes in 8- or 4-byte copies (each
//     within one tap), and where CI has no 4-byte granule (the stem's
//     CI = 3) in plain byte loads.
//   - ConvRowsA, for 1x1 filters at stride 1 without padding (32 of
//     ResNet-50's 53 convs): A is the NHWC image read as a row-major
//     (N*H*W, CI) matrix, igemm.cuh's matrix loader under its own name (so
//     a profile tells these launches from the GEMM's).
//
// What bounds it on the H100: ResNet-50's layers at batch 1 do 0.1-0.24
// GOP each against a few hundred KB of image and filter: operations at the
// int8 tensor rate in principle, the grid's fill and the pipeline's
// latency in practice (PERF.md).
//
// C interface: conv2d_s8_launch; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm.cuh"

namespace {

enum { OUT_I32 = 0, OUT_I8 = 1 };

// A(m, k) of the implicit GEMM: m = (n, oh, ow), k = (kh, kw, ci).
struct ConvTapsA {
  const int8_t* x;
  int H, W, CI, OH, OW, KH, KW, stride, pad, M;
  int g;  // bytes per copy: 16, 8 or 4 (dividing CI, x aligned), else 1
          // (igemm::granule of x and CI)

  struct Row {
    long long base;  // offset of pixel (n, ih0, iw0), channel 0
    int ih0, iw0, ok;
  };
  struct Cursor {
    int kh, kw, ci;
  };

  __device__ __forceinline__ Row row(int m) const {
    const int ow = m % OW, t = m / OW;
    const int oh = t % OH, n = t / OH;
    const int ih0 = oh * stride - pad, iw0 = ow * stride - pad;
    return {(((long long)n * H + ih0) * W + iw0) * CI, ih0, iw0, m < M};
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
    return x + r.base + ((long long)c.kh * W + c.kw) * CI + c.ci;
  }
  __device__ __forceinline__ void load(int8_t* dst, const Row& r,
                                       Cursor c) const {
    if (g == 1) {
      uint4 v = make_uint4(0, 0, 0, 0);
      for (int e = 0; e < 16 && c.kh < KH; ++e) {
        if (inside(r, c)) igemm::set_byte(v, e, *at(r, c));
        advance(c, 1);
      }
      *reinterpret_cast<uint4*>(dst) = v;
      return;
    }
    const uint32_t d = hgemm::smem_u32(dst);
    for (int o = 0; o < 16; o += g) {
      const bool in = inside(r, c);
      igemm::cp_async(d + o, in ? at(r, c) : x, g, in ? g : 0);
      advance(c, g);
    }
  }
};

// The image as a row-major (N*H*W, CI) matrix: 1x1, stride 1, no padding.
struct ConvRowsA : igemm::MatrixA {};

}  // namespace

// x: contiguous (N, H, W, CI) int8; w: contiguous (KH, KW, CI, CO) int8;
// bias: (CO,) int32 or null; out: contiguous (N, OH, OW, CO), int32
// (out_dtype 0) or int8 (1); shift in [0, 31]; workspace: inputs whose plan
// (gemm_s8_plan of (N*OH*OW, CO, KH*KW*CI)) splits K, its plan[9]
// 4-byte words owned by the stream, else null.
extern "C" int conv2d_s8_launch(const void* x, const void* w, const void* bias,
                                void* out, int n, int h, int wd, int ci,
                                int co, int kh, int kw, int stride, int pad,
                                int oh, int ow, int out_dtype, int act,
                                int shift, void* stream, void* workspace) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* B = static_cast<const int8_t*>(w);
  const int* D = static_cast<const int*>(bias);
  const int m = n * oh * ow, k = kh * kw * ci, out8 = out_dtype == OUT_I8;
  if (kh == 1 && kw == 1 && stride == 1 && pad == 0) {
    const ConvRowsA al{{X, ci, m, ci, igemm::granule(X, ci)}};
    return static_cast<int>(igemm::launch<ConvRowsA, false>(
        al, B, co, 0, D, 0, out, out8, m, co, k, shift, act, 0, workspace, s));
  }
  const ConvTapsA al{X, h, wd, ci, oh, ow, kh, kw, stride, pad, m,
                     igemm::granule(X, ci)};
  return static_cast<int>(igemm::launch<ConvTapsA, false>(
      al, B, co, 0, D, 0, out, out8, m, co, k, shift, act, 0, workspace, s));
}
