// The Gemmini peripheral: accumulator -> output epilogue, written once for
// every kernel that stores an accumulator (gemm.cu's GEMMs and
// accumulator_epilogue, conv.cu's implicit-im2col conv).
//
// Replaces: src/repro/kernels/epilogue.py apply (run inside every Pallas
// kernel's flush). Two datapaths:
//   int32 accumulator (bias already added into it): rounding right shift
//     with round-half-to-even, then the activation (NONE, RELU, RELU6 on
//     integers), then saturation to the output type (int8 or int16; int32
//     is stored as it is).
//   fp32 accumulator: + bias, activation, times 2^-shift (exact), rounded
//     to nearest even in the output type (fp32, bf16 or fp16). No
//     saturation: an fp16 overflow stores +-inf, as JAX's astype does.
// GELU and SiLU exist on the float path only; the wrappers refuse them on
// an integer accumulator, as the plain version does.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace epi {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_GELU = 3, ACT_SILU = 4 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_RELU6: return fminf(fmaxf(x, 0.f), 6.f);
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.f + expf(-x));
    default: return x;
  }
}

// An fp32 value rounded to the output type: round to nearest even; a value
// past fp16's range rounds to +-inf.
template <typename OutT> __device__ __forceinline__ OutT to(float y);
template <> __device__ __forceinline__ float to<float>(float y) { return y; }
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float y) {
  return __float2bfloat16(y);
}
template <> __device__ __forceinline__ __half to<__half>(float y) {
  return __float2half_rn(y);
}

template <typename OutT>
__device__ __forceinline__ void put(OutT* c, long long i, float y) {
  c[i] = to<OutT>(y);
}

// fp32 epilogue for one accumulator value (bias already added):
// activation, shift (a power-of-two scale, exact), rounding to the output
// type.
template <typename OutT>
__device__ __forceinline__ void store_float(OutT* C, long long i, float acc,
                                            int act, float out_scale) {
  put(C, i, activate(acc, act) * out_scale);
}

// round(x / 2^shift), ties to even; shift in [0, 31]. `>>` on a signed int
// is arithmetic (floor), as jax.lax.shift_right_arithmetic.
__device__ __forceinline__ int rounding_shift(int x, int shift) {
  if (shift <= 0) return x;
  const unsigned mask = (1u << shift) - 1u;
  const unsigned half = 1u << (shift - 1);
  const unsigned frac = static_cast<unsigned>(x) & mask;
  const int shifted = x >> shift;
  const int bump = (frac > half) || (frac == half && (shifted & 1));
  return shifted + bump;
}

__device__ __forceinline__ int activate_int(int x, int act) {
  if (act == ACT_RELU) return max(x, 0);
  if (act == ACT_RELU6) return min(max(x, 0), 6);
  return x;
}

// An int32 value saturated to the output type (int32 is stored as it is).
template <typename OutT> __device__ __forceinline__ OutT saturate(int y);
template <> __device__ __forceinline__ int8_t saturate<int8_t>(int y) {
  return static_cast<int8_t>(min(max(y, -128), 127));
}
template <> __device__ __forceinline__ int16_t saturate<int16_t>(int y) {
  return static_cast<int16_t>(min(max(y, -32768), 32767));
}
template <> __device__ __forceinline__ int saturate<int>(int y) { return y; }

__device__ __forceinline__ void put_int(int8_t* c, long long i, int y) {
  c[i] = saturate<int8_t>(y);
}
__device__ __forceinline__ void put_int(int16_t* c, long long i, int y) {
  c[i] = saturate<int16_t>(y);
}
__device__ __forceinline__ void put_int(int* c, long long i, int y) { c[i] = y; }

// The output value of one int32 accumulator value (bias included) and of
// one fp32 value: what store_int / store_float write.
template <typename OutT>
__device__ __forceinline__ OutT int_value(int acc, int shift, int act) {
  return saturate<OutT>(activate_int(rounding_shift(acc, shift), act));
}
template <typename OutT>
__device__ __forceinline__ OutT float_value(float acc, int act,
                                            float out_scale) {
  return to<OutT>(activate(acc, act) * out_scale);
}

// int32 epilogue for one accumulator value (bias included).
template <typename OutT>
__device__ __forceinline__ void store_int(OutT* C, long long i, int acc,
                                          int shift, int act) {
  C[i] = int_value<OutT>(acc, shift, act);
}

}  // namespace epi
