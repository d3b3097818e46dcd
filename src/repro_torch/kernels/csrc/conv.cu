// Conv2D for Hopper as an implicit-im2col GEMM on the int8 tensor cores.
//
// Replaces: src/repro/kernels/conv.py conv2d_implicit (_conv_kernel). On
// the TPU the padded image block sits in VMEM and each filter tap adds one
// (OH*OW, CI) x (CI, co_tile) product into an output-stationary
// accumulator, the epilogue fused on the last tap. Here the conv is one
// GEMM with M = N*OH*OW output pixels, N = CO and K = KH*KW*CI (taps
// major, channels fastest: the HWIO filter read as a row-major (K, CO)
// matrix), run by the int8 main loop of igemm.cuh in its output-stationary
// order:
//   * the A tile is gathered straight from the NHWC image in device
//     memory (16-byte vectors when CI % 16 == 0, bytes otherwise), with
//     the stride applied in the address;
//   * padding is a load predicate: no padded copy of the image and no
//     patch matrix ever exists in device memory;
//   * the int32 bias is preloaded into the accumulator and the epilogue of
//     epilogue.cuh (rounding shift, activation, saturation) runs once,
//     after the last tap;
//   * K is masked, so the stem conv (7x7x3, K = 147) needs no padding.
//
// What bounds it on the H100: ResNet-50's layers at batch 1 do 0.1-0.2
// GOP each against a few hundred KB of image and filter, so they are
// bound by operations at the int8 tensor rate in principle; the simple
// main loop (no pipelining of the gather) leaves it latency-bound for now.
//
// C interface: conv2d_s8_launch; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm.cuh"

namespace {

enum { OUT_I32 = 0, OUT_I8 = 1 };

// A(m, k) of the implicit GEMM: m = (n, oh, ow), k = (kh, kw, ci).
struct ConvA {
  const int8_t* x;
  int H, W, CI, OH, OW, KW, stride, pad, K;
  int vec;  // CI % 16 == 0 and x 16-byte aligned

  __device__ __forceinline__ uint4 load16(int m, int k) const {
    const int ow = m % OW, t = m / OW;
    const int oh = t % OH, n = t / OH;
    const int ih0 = oh * stride - pad, iw0 = ow * stride - pad;
    uint4 v = make_uint4(0, 0, 0, 0);
    int tap = k / CI, ci = k - tap * CI;
    if (vec) {  // 16 channels of one tap (k and CI are multiples of 16)
      if (k >= K) return v;
      const int ih = ih0 + tap / KW, iw = iw0 + tap % KW;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = *reinterpret_cast<const uint4*>(
            x + (((long long)n * H + ih) * W + iw) * CI + ci);
      return v;
    }
    for (int e = 0; e < 16 && k + e < K; ++e) {
      const int ih = ih0 + tap / KW, iw = iw0 + tap % KW;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        igemm::set_byte(v, e, x[(((long long)n * H + ih) * W + iw) * CI + ci]);
      if (++ci == CI) {
        ci = 0;
        ++tap;
      }
    }
    return v;
  }
};

}  // namespace

// x: contiguous (N, H, W, CI) int8; w: contiguous (KH, KW, CI, CO) int8;
// bias: (CO,) int32 or null; out: contiguous (N, OH, OW, CO), int32
// (out_dtype 0) or int8 (1); shift in [0, 31].
extern "C" int conv2d_s8_launch(const void* x, const void* w, const void* bias,
                                void* out, int n, int h, int wd, int ci,
                                int co, int kh, int kw, int stride, int pad,
                                int oh, int ow, int out_dtype, int act,
                                int shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvA al{static_cast<const int8_t*>(x), h, wd, ci, oh, ow, kw, stride,
                 pad, kh * kw * ci,
                 (ci % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0)};
  const int8_t* B = static_cast<const int8_t*>(w);
  const int* D = static_cast<const int*>(bias);
  const int m = n * oh * ow, k = kh * kw * ci;
  if (out_dtype == OUT_I8)
    return igemm::launch(al, B, co, 0, D, 0, static_cast<int8_t*>(out), m, co,
                         k, shift, act, 0, s);
  return igemm::launch(al, B, co, 0, D, 0, static_cast<int*>(out), m, co, k,
                       shift, act, 0, s);
}
