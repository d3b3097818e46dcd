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
// GELU and SiLU exist on the float path only here.
//
// Every other (accumulator, output) pair, and the products whose sum is
// rounded or wrapped to a narrower type than the main loop's, go through
// the generic datapath below (any_*: datapath.cu's epilogue_any kernel):
// a value carried as an int (int8 / int16 / int32) or an fp32 float
// (bf16 / fp16 / fp32) with its dtype code, and XLA's convert between
// any two: a float -> integer cast truncates toward zero, saturates and
// maps NaN to 0, integer -> integer wraps, the rest round to nearest even
// (an fp16 overflow reads +-inf). The epilogue is the plain version's
// (kernels/epilogue.py) step for step: an integer accumulator widened to
// int32, shifted, activated (GELU in fp32 on the value converted to fp32)
// and clipped to an int8 / int16 output; a float accumulator activated in
// its own type (each operation of a 16-bit one rounded to it, as XLA's
// CPU does) and divided by 2^shift. tanh is XLA's CPU approximation
// (tanh_xla), so GELU matches the plain version bit for bit; SiLU's exp is
// the card's.

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

// ---------------------------------------------------------------------------
// The generic datapath (any_*): dtype codes 0 int8, 1 int16, 2 int32, 3
// bf16, 4 fp16, 5 fp32.
// ---------------------------------------------------------------------------
enum { ANY_I8 = 0, ANY_I16 = 1, ANY_I32 = 2, ANY_BF16 = 3, ANY_F16 = 4,
       ANY_F32 = 5 };

__device__ __forceinline__ bool any_int(int dt) { return dt <= ANY_I32; }

// A value of any dtype: iv for the integers (sign-extended), fv for the
// floats (exact in fp32).
struct AnyVal {
  int iv;
  float fv;
};

// The storage type of each dtype code, and one stored value as an AnyVal
// and back: any_load / any_store with the dtype fixed at compile time
// (datapath.cu's convert kernels are instantiated per dtype pair).
template <int C> struct AnyT;
template <> struct AnyT<ANY_I8> { using T = int8_t; };
template <> struct AnyT<ANY_I16> { using T = int16_t; };
template <> struct AnyT<ANY_I32> { using T = int; };
template <> struct AnyT<ANY_BF16> { using T = __nv_bfloat16; };
template <> struct AnyT<ANY_F16> { using T = __half; };
template <> struct AnyT<ANY_F32> { using T = float; };

template <int C>
__device__ __forceinline__ AnyVal any_value(typename AnyT<C>::T v) {
  if constexpr (C == ANY_BF16) return {0, __bfloat162float(v)};
  else if constexpr (C == ANY_F16) return {0, __half2float(v)};
  else if constexpr (C == ANY_F32) return {0, v};
  else return {static_cast<int>(v), 0.f};
}

template <int C>
__device__ __forceinline__ typename AnyT<C>::T any_raw(AnyVal v) {
  if constexpr (C == ANY_I8) return static_cast<int8_t>(v.iv);
  else if constexpr (C == ANY_I16) return static_cast<int16_t>(v.iv);
  else if constexpr (C == ANY_I32) return v.iv;
  else if constexpr (C == ANY_BF16) return __float2bfloat16_rn(v.fv);
  else if constexpr (C == ANY_F16) return __float2half_rn(v.fv);
  else return v.fv;
}

__device__ __forceinline__ AnyVal any_load(const void* p, long long i,
                                           int dt) {
  switch (dt) {
    case ANY_I8:
      return any_value<ANY_I8>(static_cast<const int8_t*>(p)[i]);
    case ANY_I16:
      return any_value<ANY_I16>(static_cast<const int16_t*>(p)[i]);
    case ANY_I32: return any_value<ANY_I32>(static_cast<const int*>(p)[i]);
    case ANY_BF16:
      return any_value<ANY_BF16>(static_cast<const __nv_bfloat16*>(p)[i]);
    case ANY_F16:
      return any_value<ANY_F16>(static_cast<const __half*>(p)[i]);
    default: return any_value<ANY_F32>(static_cast<const float*>(p)[i]);
  }
}

__device__ __forceinline__ void any_store(void* p, long long i, int dt,
                                          AnyVal v) {
  switch (dt) {
    case ANY_I8: static_cast<int8_t*>(p)[i] = any_raw<ANY_I8>(v); break;
    case ANY_I16: static_cast<int16_t*>(p)[i] = any_raw<ANY_I16>(v); break;
    case ANY_I32: static_cast<int*>(p)[i] = any_raw<ANY_I32>(v); break;
    case ANY_BF16:
      static_cast<__nv_bfloat16*>(p)[i] = any_raw<ANY_BF16>(v);
      break;
    case ANY_F16: static_cast<__half*>(p)[i] = any_raw<ANY_F16>(v); break;
    default: static_cast<float*>(p)[i] = any_raw<ANY_F32>(v); break;
  }
}

// An fp32 value rounded to a float dtype (nearest even; fp16 past its
// range reads +-inf), as an fp32 value.
__device__ __forceinline__ float any_round(int dt, float f) {
  if (dt == ANY_BF16) return __bfloat162float(__float2bfloat16_rn(f));
  if (dt == ANY_F16) return __half2float(__float2half_rn(f));
  return f;
}

// An int wrapped to an integer dtype's width (two's complement).
__device__ __forceinline__ int any_wrap(int dt, int v) {
  if (dt == ANY_I8) return static_cast<int8_t>(v);
  if (dt == ANY_I16) return static_cast<int16_t>(v);
  return v;
}

// XLA's float -> integer convert: truncate toward zero, saturate, NaN -> 0.
__device__ __forceinline__ int any_f2i(int dt, float f) {
  if (isnan(f)) return 0;
  const float lo = dt == ANY_I8 ? -128.f : dt == ANY_I16 ? -32768.f
                                                         : -2147483648.f;
  const float hi = dt == ANY_I8 ? 127.f : dt == ANY_I16 ? 32767.f
                                                        : 2147483648.f;
  if (f <= lo) return static_cast<int>(lo);
  if (f >= hi) return dt == ANY_I32 ? 2147483647 : static_cast<int>(hi);
  return static_cast<int>(truncf(f));
}

// XLA's convert of v from dtype src to dtype dst.
__device__ __forceinline__ AnyVal any_convert(int src, int dst, AnyVal v) {
  if (any_int(src)) {
    if (any_int(dst)) return {any_wrap(dst, v.iv), 0.f};
    return {0, any_round(dst, __int2float_rn(v.iv))};
  }
  if (any_int(dst)) return {any_f2i(dst, v.fv), 0.f};
  return {0, any_round(dst, v.fv)};
}

// XLA's convert of one stored value from dtype S to dtype D, both fixed at
// compile time: any_convert's steps with its branches folded.
template <int S, int D>
__device__ __forceinline__ typename AnyT<D>::T any_cast(
    typename AnyT<S>::T v) {
  return any_raw<D>(any_convert(S, D, any_value<S>(v)));
}

// a + b in dtype dt (integers wrap; floats: the fp32 sum rounded to dt).
__device__ __forceinline__ AnyVal any_add(int dt, AnyVal a, AnyVal b) {
  if (any_int(dt))
    return {any_wrap(dt, static_cast<int>(static_cast<unsigned>(a.iv) +
                                          static_cast<unsigned>(b.iv))),
            0.f};
  return {0, any_round(dt, __fadd_rn(a.fv, b.fv))};
}

// fp32 tanh as XLA's CPU computes it (Eigen's rational approximation, its
// Horner steps fused multiply-adds, inputs clamped where it reads +-1;
// x itself below 4e-4), bit for bit the plain version's _tanh_xla.
__device__ __forceinline__ float tanh_xla(float x) {
  const float c = 7.99881172180175781f;
  const float xc = fminf(fmaxf(x, -c), c);
  const float x2 = __fmul_rn(xc, xc);
  float p = -2.76076847742355e-16f;
  p = fmaf(p, x2, 2.00018790482477e-13f);
  p = fmaf(p, x2, -8.60467152213735e-11f);
  p = fmaf(p, x2, 5.12229709037114e-08f);
  p = fmaf(p, x2, 1.48572235717979e-05f);
  p = fmaf(p, x2, 6.37261928875436e-04f);
  p = fmaf(p, x2, 4.89352455891786e-03f);
  float q = 1.19825839466702e-06f;
  q = fmaf(q, x2, 1.18534705686654e-04f);
  q = fmaf(q, x2, 2.26843463243900e-03f);
  q = fmaf(q, x2, 4.89352518554385e-03f);
  const float y = __fdiv_rn(__fmul_rn(xc, p), q);
  return fabsf(x) < 0.0004f ? x : y;
}

// jax.nn.gelu's tanh form in dtype dt (an fp32 value of it): fp32 in
// IEEE steps (no contraction), a 16-bit type with every step rounded to
// it, its constants too.
__device__ __forceinline__ float any_gelu(int dt, float x) {
  const float c0 = any_round(dt, 0.7978845608028654f);
  const float c1 = any_round(dt, 0.044715f);
  const float cube = any_round(dt, __fmul_rn(any_round(dt, __fmul_rn(x, x)),
                                             x));
  const float inner = any_round(
      dt, __fmul_rn(c0, any_round(dt, __fadd_rn(
                            x, any_round(dt, __fmul_rn(c1, cube))))));
  const float cdf = any_round(
      dt, __fmul_rn(0.5f, any_round(dt, __fadd_rn(
                              1.f, any_round(dt, tanh_xla(inner))))));
  return any_round(dt, __fmul_rn(x, cdf));
}

// x * sigmoid(x), the sigmoid 1 / (1 + exp(-x)), each step rounded to dt.
__device__ __forceinline__ float any_silu(int dt, float x) {
  const float e = any_round(dt, expf(-x));
  const float sig = any_round(dt, __fdiv_rn(1.f, any_round(dt, 1.f + e)));
  return any_round(dt, __fmul_rn(x, sig));
}

// The epilogue of one accumulator value v of dtype acc (bias added) into
// dtype out: the plain version's apply, step for step.
__device__ __forceinline__ AnyVal any_epilogue(int acc, int out, AnyVal v,
                                               int shift, int act,
                                               float out_scale) {
  if (any_int(acc)) {
    const int y = rounding_shift(v.iv, shift);
    if (act == ACT_GELU) {
      float g = any_gelu(ANY_F32, __int2float_rn(y));
      if (out == ANY_I8) g = fminf(fmaxf(g, -128.f), 127.f);
      else if (out == ANY_I16) g = fminf(fmaxf(g, -32768.f), 32767.f);
      return any_convert(ANY_F32, out, {0, g});
    }
    int z = activate_int(y, act);
    if (out == ANY_I8) z = min(max(z, -128), 127);
    else if (out == ANY_I16) z = min(max(z, -32768), 32767);
    return any_convert(ANY_I32, out, {z, 0.f});
  }
  float y = v.fv;
  switch (act) {
    case ACT_RELU: y = fmaxf(y, 0.f); break;
    case ACT_RELU6: y = fminf(fmaxf(y, 0.f), 6.f); break;
    case ACT_GELU: y = any_gelu(acc, y); break;
    case ACT_SILU:
      y = acc == ANY_F32 ? __fmul_rn(y, __fdiv_rn(1.f, 1.f + expf(-y)))
                         : any_silu(acc, y);
      break;
    default: break;
  }
  y = any_round(acc, __fmul_rn(y, out_scale));
  return any_convert(ANY_F32, out, {0, y});
}

}  // namespace epi
