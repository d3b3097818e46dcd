// Engine GEMM for Hopper: C = epilogue(A @ B + D), on both dataflows, and
// the explicit mvout epilogue.
//
// Replaces, in src/repro/kernels/gemm.py:
//   gemm_os (_os_kernel)                    -> every launcher here, ws = 0
//   gemm_ws (_ws_kernel)                    -> the same kernels, ws = 1
//   accumulator_epilogue (_epilogue_kernel) -> epilogue_kernel
// The C tile stays in an accumulator (fp32, or int32 for int8 inputs)
// while A and B stream through; D (bias: one row broadcast or a full
// (M, N) matrix) and the epilogue of epilogue.cuh -- activation, rounding
// shift, saturation or rounding to the output type -- are applied once,
// when the tile is stored.
//
// What bounds it on the H100: the serving path's GEMMs are skinny at
// decode (M = 4, one row per slot: bound by reading B, 2 bytes per weight
// at 3.35 TB/s) and wide at prefill (M = 64..1000: towards the tensor-core
// rate). B is read in whatever layout the caller holds it -- row-major
// (K, N) weights, or the tied unembedding's (N, K) table read as its
// transpose without a copy (the table is 604 MB at full width).
//
// Inputs: bf16 runs hgemm.cuh (two regimes by M: split-K mma.sync fed
// straight into registers for M <= 16, wgmma fed by TMA for wider M; its
// header says what bounds each and what the design does about it); fp32
// runs sgemm.cuh on CUDA-core FMAs (no TF32), so the fp32 engine config
// stays IEEE (register micro-tiles, a cp.async ring, split K where the
// tiles leave SMs idle); int8 runs on the int8 tensor cores (igemm.cuh:
// mma.sync s8 fed by a cp.async ring, tiles and K splits from the shape,
// every int32 add wrapping, the tile staged through shared memory for the
// bias and the epilogue). fp16 and int16 inputs run hgemm.cuh's fp16 and
// igemm.cuh's int16 (byte-plane) instantiations from gemm16.cu, a source
// of their own so that its build runs beside this one. Float inputs store fp32, bf16 or
// fp16; int8 inputs int32, int8 or int16. Ragged M, N and K edges are
// masked here; callers pass operands at their true size.
//
// Dataflows: on the TPU, WS is a weight-major grid (gn, gm, gk) around a
// VMEM accumulator, with the same numerics as OS. Here ws = 1 walks the
// blocks weight-major (all M tiles of one N strip before the next). Every
// block computes its tile the same way in both orders (the tiles and K
// splits of every plan depend on the shape alone, and int sums wrap), so
// WS equals OS bit for bit.
//
// accumulator_epilogue: one elementwise pass over a raw (M, N) int32 or
// fp32 accumulator, bound by its bytes (4 in, 1..4 out per element): runs
// of four values, one 16-byte load and one packed store each, on a grid
// of at most four blocks an SM; any shape and any 4-byte-aligned base.
//
// C interface: gemm_launch (bf16 / fp32 inputs), gemm_plan (the bf16,
// fp16, fp32 or int16 kernel's plan for a shape), gemm_s8_launch (int8
// inputs), gemm_s8_plan (the int8 kernel's plan), epilogue_launch; each
// launch returns cudaGetLastError(). The GEMM entries take an optional
// plan (tile, splits), the tuner's: 0, 0 runs the plan of the shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"
#include "hgemm.cuh"
#include "igemm.cuh"
#include "sgemm.cuh"

namespace {

// Float codes (inputs and outputs), and int16 inputs in gemm_plan.
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I16 = 3 };
// Integer output codes.
enum { OUT_I32 = 0, OUT_I8 = 1, OUT_I16 = 2 };

template <typename OutT>
int launch_typed(const void* a, const void* b, const float* d, OutT* c, int m,
                 int n, int k, long long lda, long long ldb, int b_trans,
                 long long ldd, int in_dtype, int act, float out_scale, int ws,
                 void* workspace, cudaStream_t s, int tile, int splits) {
  if (in_dtype == DT_BF16)
    return static_cast<int>(hgemm::launch<__nv_bfloat16, OutT>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), d, c, m, n, k, lda, ldb,
        b_trans, ldd, act, out_scale, ws, workspace, s, tile, splits));
  return static_cast<int>(sgemm::launch_gemm<float, OutT>(
      static_cast<const float*>(a), static_cast<const float*>(b), d, c, m, n,
      k, lda, ldb, b_trans, ldd, act, 0, out_scale, ws, workspace, s, tile,
      splits));
}

// accumulator_epilogue. Each thread takes whole runs of four values: one
// 16-byte load of the accumulator, four epilogues, and one packed store of
// the four outputs (4, 8 or 16 bytes), two runs in flight per iteration.
// The elements before the first 16-byte-aligned accumulator address (the
// head) and after the last whole run (the tail) are done one by one. Where
// the head leaves the output off its packed alignment (C is written from
// element 0, the accumulator read from a slice's offset), the runs store
// their four outputs one by one.
constexpr int kEpiThreads = 256;

template <typename AccT> struct Vec4;
template <> struct Vec4<int> { using T = int4; };
template <> struct Vec4<float> { using T = float4; };

__device__ __forceinline__ unsigned bits(int8_t x) {
  return static_cast<uint8_t>(x);
}
__device__ __forceinline__ unsigned bits(int16_t x) {
  return static_cast<uint16_t>(x);
}
__device__ __forceinline__ unsigned bits(__half x) { return __half_as_ushort(x); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned bits(int x) { return static_cast<unsigned>(x); }
__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }

template <typename AccT, typename OutT>
__device__ __forceinline__ OutT epi_value(AccT a, int shift, int act,
                                          float out_scale) {
  if constexpr (std::is_integral<AccT>::value)
    return epi::int_value<OutT>(a, shift, act);
  else
    return epi::float_value<OutT>(a, act, out_scale);
}

// Four outputs at c (packed: c aligned to 4 outputs; else one by one).
template <typename OutT>
__device__ __forceinline__ void store4(OutT* c, const OutT (&o)[4],
                                       bool packed) {
  if (!packed) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = o[j];
  } else if constexpr (sizeof(OutT) == 1) {
    *reinterpret_cast<unsigned*>(c) = bits(o[0]) | bits(o[1]) << 8 |
                                      bits(o[2]) << 16 | bits(o[3]) << 24;
  } else if constexpr (sizeof(OutT) == 2) {
    *reinterpret_cast<uint2*>(c) = make_uint2(bits(o[0]) | bits(o[1]) << 16,
                                              bits(o[2]) | bits(o[3]) << 16);
  } else {
    *reinterpret_cast<uint4*>(c) =
        make_uint4(bits(o[0]), bits(o[1]), bits(o[2]), bits(o[3]));
  }
}

template <typename AccT, typename OutT>
__device__ __forceinline__ void epi_run(const typename Vec4<AccT>::T& v,
                                        OutT* c, bool packed, int shift,
                                        int act, float out_scale) {
  const OutT o[4] = {epi_value<AccT, OutT>(v.x, shift, act, out_scale),
                     epi_value<AccT, OutT>(v.y, shift, act, out_scale),
                     epi_value<AccT, OutT>(v.z, shift, act, out_scale),
                     epi_value<AccT, OutT>(v.w, shift, act, out_scale)};
  store4(c, o, packed);
}

// acc[0, head) and acc[head + 4 * runs, count) one by one; the runs of
// four in between from 16-byte-aligned loads.
template <typename AccT, typename OutT>
__global__ void __launch_bounds__(kEpiThreads)
epilogue_kernel(const AccT* __restrict__ acc, OutT* __restrict__ C,
                long long count, int head, int packed, int shift, int act,
                float out_scale) {
  using V = typename Vec4<AccT>::T;
  const long long runs = (count - head) / 4;
  const long long tid = blockIdx.x * (long long)kEpiThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kEpiThreads;
  const long long tail = head + 4 * runs;
  if (tid < head)
    C[tid] = epi_value<AccT, OutT>(acc[tid], shift, act, out_scale);
  if (tid < count - tail)
    C[tail + tid] =
        epi_value<AccT, OutT>(acc[tail + tid], shift, act, out_scale);
  const V* av = reinterpret_cast<const V*>(acc + head);
  OutT* c = C + head;
  for (long long r = tid; r < runs; r += 2 * stride) {
    const long long r2 = r + stride;
    const V v0 = av[r];
    V v1;
    if (r2 < runs) v1 = av[r2];
    epi_run<AccT, OutT>(v0, c + 4 * r, packed, shift, act, out_scale);
    if (r2 < runs)
      epi_run<AccT, OutT>(v1, c + 4 * r2, packed, shift, act, out_scale);
  }
}

template <typename AccT, typename OutT>
int launch_epilogue(const void* acc, void* c, long long count, int shift,
                    int act, float out_scale, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(acc);
  if (addr % sizeof(AccT)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long head = std::min<long long>(
      count, (16 - addr % 16) % 16 / sizeof(AccT));
  const bool packed = reinterpret_cast<uintptr_t>(static_cast<OutT*>(c) +
                                                  head) %
                          (4 * sizeof(OutT)) ==
                      0;
  const long long runs = (count - head) / 4;
  // Two runs a thread; at most four blocks an SM, looping beyond that.
  const long long want = (runs + 2 * kEpiThreads - 1) / (2 * kEpiThreads);
  const long long blocks = std::max<long long>(
      1, std::min<long long>(want, 4LL * hgemm::sm_count()));
  epilogue_kernel<AccT, OutT><<<(unsigned)blocks, kEpiThreads, 0, s>>>(
      static_cast<const AccT*>(acc), static_cast<OutT*>(c), count,
      static_cast<int>(head), packed ? 1 : 0, shift, act, out_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, K) with row stride lda; b: (K, N) read as b[k * ldb + n], or as
// b[n * ldb + k] when b_trans; d: fp32 bias, row stride ldd (0 broadcasts
// one row), or null; c: contiguous (M, N) output; in_dtype fp32 (0) or
// bf16 (1); out_dtype fp32 (0), bf16 (1) or fp16 (2); ws: weight-major
// order; workspace: inputs whose plan splits K, gemm_plan's plan[9] 4-byte
// words owned by the stream (tickets zeroed when it was made), else null;
// tile, splits: the caller's plan (gemm_plan's tile codes), or 0, 0 for
// the call's own; a plan the kernel cannot run is cudaErrorInvalidValue.
extern "C" int gemm_launch(const void* a, const void* b, const void* d, void* c,
                           int m, int n, int k, long long lda, long long ldb,
                           int b_trans, long long ldd, int in_dtype,
                           int out_dtype, int act, float out_scale, int ws,
                           void* stream, void* workspace, int tile,
                           int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* D = static_cast<const float*>(d);
  if (out_dtype == DT_BF16)
    return launch_typed<__nv_bfloat16>(
        a, b, D, static_cast<__nv_bfloat16*>(c), m, n, k, lda, ldb, b_trans,
        ldd, in_dtype, act, out_scale, ws, workspace, s, tile, splits);
  if (out_dtype == DT_F16)
    return launch_typed<__half>(a, b, D, static_cast<__half*>(c), m, n, k, lda,
                                ldb, b_trans, ldd, in_dtype, act, out_scale,
                                ws, workspace, s, tile, splits);
  return launch_typed<float>(a, b, D, static_cast<float*>(c), m, n, k, lda,
                             ldb, b_trans, ldd, in_dtype, act, out_scale, ws,
                             workspace, s, tile, splits);
}

// The kernel's plan for an (M, N, K) call with fp32 (in_dtype 0), bf16
// (1), fp16 (2) or int16 (3) inputs on the current device, B row-major
// (b_trans 0) or read as a transpose (1); launches nothing. bf16 and fp16
// take the same plan (hgemm.cuh's, from the shape alone), fp32
// sgemm.cuh's tiles and splits, int16 igemm.cuh's (the int8 plan over 2 K
// bytes). plan: [0] regime (0 skinny: mma.sync split K for bf16 / fp16,
// 16 x 64 tiles for int16; 1 wide; 2 fp32 CUDA cores; 3 square: int16's 64
// x 64 tiles), [1] block rows, [2] block columns, [3] k per stage, [4] K
// splits, [5] blocks, [6] threads per block, [7] ring stages, [8] shared
// memory bytes, [9] workspace 4-byte words (0 for one split), [10] the
// plan's tile code. tile, splits: the caller's plan, or 0, 0 for the
// call's own; tile codes: bf16 / fp16 1 skinny (M <= 16), 2-5 the wide
// tiles 128 x 64, 128 x 128, 128 x 256, 64 x 256 (M > 16); fp32 1 and 2
// for 64- and 128-row tiles; int16 1 skinny, 2 square (any M); a plan the
// kernel cannot run is cudaErrorInvalidValue.
extern "C" int gemm_plan(int m, int n, int k, int b_trans, int in_dtype,
                         int tile, int splits, long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DT_F32) {
    sgemm::Plan p;
    if (!sgemm::resolve<float>(m, n, k, b_trans, hgemm::sm_count(), tile,
                               splits, p))
      return bad;
    const long long out[11] = {2,        p.bm,     p.bn,      p.bk,
                               p.splits, p.blocks, p.threads, p.stages,
                               p.smem,   p.ws_words, sgemm::tile_code(p)};
    for (int i = 0; i < 11; ++i) plan[i] = out[i];
    return 0;
  }
  if (in_dtype == DT_I16) {
    igemm::Plan p;
    if (!igemm::resolve_here(m, n, k, b_trans, 2, tile, splits, p))
      return bad;
    const long long out[11] = {p.regime == igemm::SKINNY ? 0 : 3,
                               p.bm,     p.bn,     igemm::BK / 2,
                               p.splits, p.blocks, p.threads, p.stages,
                               p.smem,   p.ws_words, igemm::tile_code(p)};
    for (int i = 0; i < 11; ++i) plan[i] = out[i];
    return 0;
  }
  hgemm::Plan p;
  if (!hgemm::resolve(m, n, k, b_trans, hgemm::sm_count(), tile, splits, p))
    return bad;
  const long long out[11] = {p.wide,   p.bm,     p.bn,      p.bk,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, hgemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}

// The int8 kernel's plan for an (M, N, K) call on the current device, B
// row-major (b_trans 0) or read as a transpose (1), in either order;
// launches nothing. plan: [0] regime (0 skinny 16 x 64, 1 square 64 x 64),
// [1] block rows, [2] block columns, [3] k per stage, [4] K splits, [5]
// blocks, [6] threads per block, [7] ring stages, [8] shared memory bytes,
// [9] workspace 4-byte words (0 for one split), [10] the tile code (1
// skinny, 2 square). tile, splits: the caller's plan (either tile at any
// M), or 0, 0 for the call's own; a plan the kernel cannot run is
// cudaErrorInvalidValue.
extern "C" int gemm_s8_plan(int m, int n, int k, int b_trans, int tile,
                            int splits, long long* plan) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  igemm::Plan p;
  if (!igemm::resolve_here(m, n, k, b_trans, 1, tile, splits, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out[11] = {p.regime, p.bm,     p.bn,      igemm::BK,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, igemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}

// int8 inputs, int32 accumulator: a, b as for gemm_launch; d: int32 bias,
// row stride ldd (0 broadcasts one row), or null; c: contiguous (M, N)
// int32 (out_dtype 0), int8 (1) or int16 (2); shift in [0, 31]; ws:
// weight-stationary;
// workspace: inputs whose plan splits K, gemm_s8_plan's plan[9] 4-byte
// words owned by the stream (tickets zeroed when it was made), else null;
// tile, splits: as for gemm_s8_plan.
extern "C" int gemm_s8_launch(const void* a, const void* b, const void* d,
                              void* c, int m, int n, int k, long long lda,
                              long long ldb, int b_trans, long long ldd,
                              int out_dtype, int act, int shift, int ws,
                              void* stream, void* workspace, int tile,
                              int splits) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const igemm::MatrixA al{A, lda, m, k, igemm::granule(A, lda)};
  return static_cast<int>(igemm::launch<int8_t>(
      al, static_cast<const int8_t*>(b), ldb, b_trans,
      static_cast<const int*>(d), ldd, c, out_dtype, m, n, k, shift, 1.f, act,
      ws, workspace, static_cast<cudaStream_t>(stream), 0, tile, splits));
}

// acc: contiguous int32 (acc_dtype 0) or fp32 (1) values; c: the same
// count of int32 / int8 / int16 (int acc) or fp32 / bf16 / fp16 (fp32 acc)
// outputs, by out_dtype (0 = int32 or fp32, 1 = int8 or bf16, 2 = int16 or
// fp16).
extern "C" int epilogue_launch(const void* acc, void* c, long long count,
                               int acc_dtype, int out_dtype, int act,
                               int shift, float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == 0) {
    if (out_dtype == OUT_I8)
      return launch_epilogue<int, int8_t>(acc, c, count, shift, act,
                                          out_scale, s);
    if (out_dtype == OUT_I16)
      return launch_epilogue<int, int16_t>(acc, c, count, shift, act,
                                           out_scale, s);
    return launch_epilogue<int, int>(acc, c, count, shift, act, out_scale, s);
  }
  if (out_dtype == DT_BF16)
    return launch_epilogue<float, __nv_bfloat16>(acc, c, count, shift, act,
                                                 out_scale, s);
  if (out_dtype == DT_F16)
    return launch_epilogue<float, __half>(acc, c, count, shift, act,
                                          out_scale, s);
  return launch_epilogue<float, float>(acc, c, count, shift, act, out_scale,
                                       s);
}
