// The generic flash and paged prefill kernel for 16-bit operands on
// Hopper: wgmma at the head dim's own width, the keys of a query tile
// loaded by a producer warpgroup (TMA, else cp.async, else element
// copies) into 128-byte swizzled rings, column slices of V and O above
// 256. attention_wg.cu (bf16) and attention_wg16.cu (fp16) instantiate it.
//
// Replaces, in src/repro/kernels/attention.py, flash_attention (:123, its
// pallas_call :162) and paged_prefill_attention (:488, :558) for bf16 and
// fp16 operands on every call attention.cu does not take: a head dim that
// is not 16, 32, 64, 128 or 256, any head dim above 256, and rows that are
// not whole 16-byte words on 16-byte boundaries. (attention.cuh's
// flash_tc_kernel ran them before: mma.sync on 16-row tiles at the next
// power-of-two width, 16-bit head dims above 256 widened to fp32.)
//
// What bounds it on the H100: at the calls it serves (a 256-token chunk,
// 32 query heads, head dims 48-1024) neither bytes (~1-8 MB) nor
// operations (~0.1-1 GFLOP at 989 TFLOP/s) but the latency of a block's
// chain: loads, two products and a softmax a key tile. The design:
//   - A block is one consumer warpgroup and one producer warpgroup. The
//     consumer owns 64 query rows: (position, query head) pairs of one kv
//     head, position-major, PG = gcd(G, 64) heads a position (G query heads
//     a kv head), so a key tile serves PG heads at once and a causal row
//     tile spans 64 / PG positions. setmaxnreg moves registers from the
//     producer (40) to the consumer (216, two blocks an SM up to width
//     160 where shared memory holds them; 232 above, one block an SM).
//   - The producer fills a ring of K chunks (64 keys x 64 columns, 8 KB)
//     and a ring of V tiles (64 keys x the slice's columns) in the 128-byte
//     swizzled layout wgmma reads, full / empty mbarriers between the two.
//     Its first thread issues TMA boxes where the rows are whole aligned
//     16-byte words (dense K / V by 4-D maps whose key axis ends at Tk, so
//     keys past it arrive as zeros; paged K / V one box a page where a page
//     holds 8k keys and divides or is divided by a key tile, except the
//     tile past the chunk's last key, whose dead rows may hold anything).
//     Otherwise all 128 threads copy, zeros outside the live keys: cp.async
//     by 16 bytes, or by 4 bytes for rows on 4-byte boundaries, or element
//     by element, their completion counted on the same barrier. Only the
//     producer knows which path a tile took.
//   - S = Q K^T on wgmma m64n64k16 (fp32 sums), Q resident in shared
//     memory, ceil(d / 16) k steps: the head dim's own width. Scale,
//     softcap and the causal / window masks on the fp32 registers; the
//     online softmax keeps fp32 row statistics over the lane quad.
//   - P V with P = P_hi + P_lo, two 16-bit register A fragments, both
//     wgmma m64nDVk16 into one fp32 accumulator: the numeric contract of
//     flash_tc_kernel (attention.cuh), so the bf16 and fp16 rules hold.
//   - DV, the columns of V and O a block computes, is an instance width: a
//     multiple of 16 up to 128, of 32 above (at most 1.25 d for d >= 64).
//     A head dim above 256 runs ceil(d / 256) column slices on the grid's
//     z axis, each at the width of d / slices: every slice block computes
//     the scores over the whole d (Q resident, K streamed a chunk at a
//     time) and P V over its own columns.
//   - The live key tiles of a row tile split over the 1-4 blocks of a
//     cluster, round robin, where the grid leaves SMs free; each block's
//     (m, l, O) partial goes to its shared memory, and after a cluster
//     barrier block r merges rows [r 64 / CL, (r + 1) 64 / CL) over
//     distributed shared memory in rank order, so a rerun is bit-equal.
//
// C interface (each unit, its own element type): attention.cuh's
// flash_attention_launch and paged_prefill_launch (cudaGetLastError(), or
// cudaErrorInvalidValue for a call no plan holds), flash_attention_plan
// and paged_prefill_plan (the geometry a call runs, with the rows'
// alignment and the page size; launches nothing).

#pragma once

#include <float.h>

#include "hgemm.cuh"

namespace attn_wg {

namespace cg = cooperative_groups;
using hgemm::bf16;
using hgemm::mbar_arrive;
using hgemm::mbar_expect;
using hgemm::mbar_init;
using hgemm::mbar_wait;
using hgemm::smem_u32;
using hgemm::sw128_desc;

constexpr float NEG = -0.7f * FLT_MAX;   // attention.cuh's mask constant
constexpr int KT = 64;                   // keys a tile
constexpr int ROWS = 64;                 // query rows a block
constexpr int THREADS = 256;             // consumer + producer warpgroups
constexpr int CHUNK = 64 * 128;          // a 64-row x 64-column ring slot
constexpr int MAX_CLUSTER = 4;
constexpr int SLICE = 256;               // V / O columns a block at most
constexpr int KS_MAX = 16, VS_MAX = 2;   // ring depths
constexpr int PRODUCER_REGS = 40;
// dynamic shared memory a block may take: one block an SM, or two
constexpr int SMEM_ONE = 232448 - 512, SMEM_TWO = 233472 / 2 - 1024 - 512;
constexpr int WIDTHS[12] = {16, 32, 48, 64, 80, 96, 112, 128,
                            160, 192, 224, 256};
enum { LOAD_TMA = 0, LOAD_CP16 = 1, LOAD_CP4 = 2, LOAD_ELEM = 3 };

// Blocks an SM by the instance's launch bounds, and the consumer's
// registers after setmaxnreg (the producer keeps 40). Two blocks (128
// registers a thread at launch, 40 + 216 a thread pair) up to width 160:
// ptxas compiles the whole kernel within the launch's count, and a wgmma
// of N = 256 needs 158 (its 128 accumulators); one block above (232), where
// one block an SM against two took D = 80 from 0.0214 to 0.0279 ms on an
// H100 (PERF.md §6).
__host__ __device__ constexpr int blocks_per_sm(int dv) {
  return dv <= 160 ? 2 : 1;
}
__host__ __device__ constexpr int consumer_regs(int dv) {
  return dv <= 160 ? 216 : 232;
}


struct Args {
  const void* q;       // (B, Tq, H, d)
  const void* k;       // dense: (B, Tk, KVH, d); paged: pool (KVH, NPOOL, PAGE, d)
  const void* v;
  void* o;             // (B, Tq, H, d)
  const int* table;    // paged: logical page -> pool page (B = 1)
  int Tq, Tk, H, KVH, G, pg;
  int q_offset;        // position of query row 0
  int causal, window;  // window 0 = global
  int paged, npool, page;
  int d, nch, ksteps;  // head dim, its 64-column chunks and 16-column steps
  int slices;          // column slices of V / O (grid z: innermost)
  int load;            // LOAD_*: how the producer fills the rings
  int box_rows;        // paged TMA: key rows a box
  int ks, vs;          // ring depths: K chunks, V tiles
  int vec_o;           // output rows 8-byte aligned
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The copies this thread issued complete on bar as one more arrival than
// the phase expects; the producer's first thread then arrives once.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, int z, int w,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(z), "r"(w), "r"(bar)
      : "memory");
}

// 8 elements at src, n of them live (n <= 0: none), into the 16 bytes at
// shared address dst, zeros past n: cp.async of 16 bytes (src on 16 bytes),
// of 4 (src on 4 bytes) or element by element. safe: any valid address,
// handed to a copy that reads nothing.
__device__ __forceinline__ void copy8(uint32_t dst, const uint16_t* src,
                                      int n, int load, const void* safe) {
  if (load == LOAD_CP16) {
    const int bytes = n >= 8 ? 16 : n > 0 ? 2 * n : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(bytes > 0 ? (const void*)src : safe),
                    "r"(bytes)
                 : "memory");
  } else if (load == LOAD_CP4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int left = n - 2 * e;
      const int bytes = left >= 2 ? 4 : left == 1 ? 2 : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst + 4 * e),
                      "l"(bytes > 0 ? (const void*)(src + 2 * e) : safe),
                      "r"(bytes)
                   : "memory");
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = 2 * e < n ? src[2 * e] : 0u;
      const uint32_t hi = 2 * e + 1 < n ? src[2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}
// Byte offset of 16-byte unit w of row r in a 128-byte swizzled slot.
__device__ __forceinline__ uint32_t swz(int r, int w) {
  return r * 128 + ((w ^ (r & 7)) << 4);
}

// A 16-bit element type's pair (round to nearest even).
template <typename T> struct Pair;
template <> struct Pair<bf16> {
  static __device__ __forceinline__ uint32_t make(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 f2(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};
template <> struct Pair<__half> {
  static __device__ __forceinline__ uint32_t make(float x, float y) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 f2(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};
// (x, y) as a T pair hi plus the pair of what rounding left, lo.
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Pair<T>::make(x, y);
  const float2 h = Pair<T>::f2(hi);
  lo = Pair<T>::make(x - h.x, y - h.y);
}
__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void st1(__half* p, float v) {
  *p = __float2half_rn(v);
}

// wgmma with fp32 sums: S (64 x 64) += Q K^T from two shared descriptors
// (B K-major), and O (64 x N) += P V, P from registers, V MN-major.
// acc = 0 overwrites the sum. (Written out per width: the instruction
// names its accumulator registers one by one.)
#define WG_SS_64(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_16(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_32(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_48(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %29, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23" \
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_64(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_80(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %45, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39" \
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_96(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %53, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47" \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_112(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %61, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n112k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55" \
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_128(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_160(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %85, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79" \
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_192(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95" \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_224(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %117, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n224k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111" \
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

#define WG_RS_256(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc) \
      : "memory")

template <typename T>
__device__ __forceinline__ void wg_qk(float (&d)[32], uint64_t da, uint64_t db,
                                      int acc) {
  if constexpr (std::is_same<T, bf16>::value) WG_SS_64("bf16");
  else WG_SS_64("f16");
}

#define WG_RS_CASE(N)                                        \
  if constexpr (DV == N) {                                   \
    if constexpr (std::is_same<T, bf16>::value) WG_RS_##N("bf16"); \
    else WG_RS_##N("f16");                                   \
  }
template <int DV, typename T>
__device__ __forceinline__ void wg_pv(float (&d)[DV / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  constexpr int acc = 1;
  WG_RS_CASE(16) WG_RS_CASE(32) WG_RS_CASE(48) WG_RS_CASE(64)
  WG_RS_CASE(80) WG_RS_CASE(96) WG_RS_CASE(112) WG_RS_CASE(128)
  WG_RS_CASE(160) WG_RS_CASE(192) WG_RS_CASE(224) WG_RS_CASE(256)
}
#undef WG_RS_CASE

// Live keys [lo, hi) of the query positions [p0, p1] (the TPU kernels'
// block_live rule, per row tile).
__host__ __device__ __forceinline__ void tile_keys(int p0, int p1, int Tk,
                                                   int causal, int window,
                                                   int& lo, int& hi) {
  lo = window > 0 && p0 - window + 1 > 0 ? p0 - window + 1 : 0;
  hi = causal && p1 + 1 < Tk ? p1 + 1 : Tk;
}

// ---------------------------------------------------------------------------
// the kernel: grid (cluster rank, row tile, slice + slices x (head group,
// kv head, sequence)); warpgroup 0 consumes, warpgroup 1 produces
// ---------------------------------------------------------------------------
template <int DV, typename T>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(DV))
flash_wg_kernel(const Args p, const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v) {
  constexpr int DVB = (DV + 63) / 64;        // 64-column blocks of a V tile
  constexpr int VST = DVB * CHUNK;           // bytes of a V tile
  constexpr int LDO = DV + 8;                // floats a staged O row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qfull;
  __shared__ __align__(8) uint64_t kfull[KS_MAX], kempty[KS_MAX];
  __shared__ __align__(8) uint64_t vfull[VS_MAX], vempty[VS_MAX];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* const part = reinterpret_cast<float*>(smem_raw + (sbase - raw));
  const uint32_t qs = sbase, ks0 = qs + p.nch * CHUNK,
                 vs0 = ks0 + p.ks * CHUNK;

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int z = blockIdx.z;
  const int s = z % p.slices;
  z /= p.slices;
  const int nhg = p.G / p.pg;
  const int hg = z % nhg;
  z /= nhg;
  const int kvh = z % p.KVH, b = z / p.KVH;
  const int rp = ROWS / p.pg;                          // positions a tile
  const int i0 = (gridDim.y - 1 - blockIdx.y) * rp;    // latest rows first
  const int h0 = kvh * p.G + hg * p.pg;                // its first head
  const int p0 = p.q_offset + i0;
  const int p1 = p.q_offset + min(i0 + rp, p.Tq) - 1;
  int k_lo, k_hi;
  tile_keys(p0, p1, p.Tk, p.causal, p.window, k_lo, k_hi);
  const int t_first = k_lo / KT;
  const int t_end = k_hi > k_lo ? (k_hi + KT - 1) / KT : t_first;
  const int n_tiles = t_end - t_first > rank
                          ? (t_end - t_first - rank + CL - 1) / CL : 0;
  const uint16_t* const qg = static_cast<const uint16_t*>(p.q);
  const uint16_t* const kg = static_cast<const uint16_t*>(p.k);
  const uint16_t* const vg = static_cast<const uint16_t*>(p.v);

  if (tid == 0) {
    mbar_init(smem_u32(&qfull), 1);
    for (int i = 0; i < p.ks; ++i) {
      mbar_init(smem_u32(&kfull[i]), 1);
      mbar_init(smem_u32(&kempty[i]), 4);
    }
    for (int i = 0; i < p.vs; ++i) {
      mbar_init(smem_u32(&vfull[i]), 1);
      mbar_init(smem_u32(&vempty[i]), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ----------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int pt = tid - 128;
    // where key row kpos of this kv head lies (kpos inside [0, Tk))
    auto key_row = [&](const uint16_t* base, int kpos) {
      const long long r =
          p.paged ? ((long long)kvh * p.npool + __ldg(p.table + kpos / p.page)) *
                            p.page + kpos % p.page
                  : ((long long)b * p.Tk + kpos) * p.KVH + kvh;
      return base + r * p.d;
    };
    // every thread's copies, then one arrival: the slot is full
    auto publish = [&](uint32_t bar) {
      cp_async_arrive(bar);
      fence_async_smem();
      named_sync(1);
      if (pt == 0) mbar_arrive(bar);
    };
    if (n_tiles > 0) {
      const uint32_t qbar = smem_u32(&qfull);
      if (p.load == LOAD_TMA) {
        if (pt == 0) {
          asm volatile("prefetch.tensormap [%0];\n"
                       :: "l"(reinterpret_cast<uint64_t>(&map_k)) : "memory");
          asm volatile("prefetch.tensormap [%0];\n"
                       :: "l"(reinterpret_cast<uint64_t>(&map_v)) : "memory");
          mbar_expect(qbar, p.nch * CHUNK);
          for (int c = 0; c < p.nch; ++c)
            tma_4d(qs + c * CHUNK, &map_q, 64 * c, h0, i0, b, qbar);
        }
      } else {
        for (int u = pt; u < p.nch * ROWS * 8; u += 128) {
          const int c = u / (ROWS * 8), r = (u >> 3) % ROWS, w = u & 7;
          const int i = i0 + r / p.pg, col = 64 * c + 8 * w;
          const bool ok = i < p.Tq;
          const uint16_t* src =
              qg + ((long long)(b * p.Tq + (ok ? i : 0)) * p.H + h0 +
                    r % p.pg) * p.d + col;
          copy8(qs + c * CHUNK + swz(r, w), src, ok ? p.d - col : 0, p.load,
                qg);
        }
        publish(qbar);
      }
      int kit = 0, vit = 0;
      for (int n = 0; n < n_tiles; ++n) {
        const int t = t_first + rank + n * CL, k0 = t * KT;
        // TMA, except a paged tile reaching past the last key
        const bool tma = p.load == LOAD_TMA && (!p.paged || k0 + KT <= p.Tk);
        int rows[KT / 8];
        if (tma && p.paged && pt == 0)
          for (int j = 0; j < KT / p.box_rows; ++j) {
            const int kpos = k0 + j * p.box_rows;
            rows[j] = (kvh * p.npool + __ldg(p.table + kpos / p.page)) *
                          p.page + kpos % p.page;
          }
        for (int c = 0; c < p.nch; ++c, ++kit) {
          const int slot = kit % p.ks;
          if (kit >= p.ks)
            mbar_wait(smem_u32(&kempty[slot]), ((kit / p.ks) - 1) & 1);
          const uint32_t dst = ks0 + slot * CHUNK;
          const uint32_t bar = smem_u32(&kfull[slot]);
          if (tma) {
            if (pt == 0) {
              mbar_expect(bar, CHUNK);
              if (p.paged) {
                for (int j = 0; j < KT / p.box_rows; ++j)
                  tma_2d(dst + j * p.box_rows * 128, &map_k, 64 * c, rows[j],
                         bar);
              } else {
                tma_4d(dst, &map_k, 64 * c, kvh, k0, b, bar);
              }
            }
          } else {
            for (int u = pt; u < KT * 8; u += 128) {
              const int r = u >> 3, w = u & 7, kpos = k0 + r;
              const int col = 64 * c + 8 * w;
              const bool ok = kpos >= k_lo && kpos < k_hi;
              copy8(dst + swz(r, w), ok ? key_row(kg, kpos) + col : kg,
                    ok ? p.d - col : 0, p.load, kg);
            }
            publish(bar);
          }
        }
        const int slot = vit % p.vs;
        if (vit >= p.vs)
          mbar_wait(smem_u32(&vempty[slot]), ((vit / p.vs) - 1) & 1);
        ++vit;
        const uint32_t dst = vs0 + slot * VST;
        const uint32_t bar = smem_u32(&vfull[slot]);
        const int c0 = s * DV;
        if (tma) {
          if (pt == 0) {
            mbar_expect(bar, VST);
#pragma unroll
            for (int blk = 0; blk < DVB; ++blk) {
              if (p.paged) {
                for (int j = 0; j < KT / p.box_rows; ++j)
                  tma_2d(dst + blk * CHUNK + j * p.box_rows * 128, &map_v,
                         c0 + 64 * blk, rows[j], bar);
              } else {
                tma_4d(dst + blk * CHUNK, &map_v, c0 + 64 * blk, kvh, k0, b,
                       bar);
              }
            }
          }
        } else {
          for (int u = pt; u < DVB * KT * 8; u += 128) {
            const int blk = u / (KT * 8), r = (u >> 3) % KT, w = u & 7;
            const int kpos = k0 + r, col = c0 + 64 * blk + 8 * w;
            const bool ok = kpos >= k_lo && kpos < k_hi;
            copy8(dst + blk * CHUNK + swz(r, w),
                  ok ? key_row(vg, kpos) + col : vg, ok ? p.d - col : 0,
                  p.load, vg);
          }
          publish(bar);
        }
      }
    }
    if (CL > 1) {                       // the consumers' two cluster barriers
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // ------------------------------------------------------------- consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(consumer_regs(DV)));
  const int g = lane >> 2, qd = lane & 3;
  // this thread's rows: 16 warp + g (+ 8); their query positions
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = p.q_offset + i0 + (16 * warp + g + 8 * h) / p.pg;
  // keys every row of the tile sees: tiles inside need no mask
  const int all_lo = p.window > 0 ? p1 - p.window + 1 : 0;
  const int all_hi = p.causal ? min(p.Tk, p0 + 1) : p.Tk;

  float o[DV / 2], sc[32], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  if (n_tiles > 0) {
    mbar_wait(smem_u32(&qfull), 0);
    fence_async_smem();
  }
  int kit = 0, vit = 0;
  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = (t_first + rank + n * CL) * KT;
    // S = Q K^T over the head dim, a 64-column chunk at a time
    for (int c = 0; c < p.nch; ++c, ++kit) {
      const int slot = kit % p.ks;
      mbar_wait(smem_u32(&kfull[slot]), (kit / p.ks) & 1);
      fence_async_smem();
      const uint32_t sq = qs + c * CHUNK, sk = ks0 + slot * CHUNK;
      hgemm::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < p.ksteps)
          wg_qk<T>(sc, sw128_desc(sq + 32 * j, 16, 1024),
                   sw128_desc(sk + 32 * j, 16, 1024), c > 0 || j > 0);
      hgemm::wgmma_commit();
      hgemm::wgmma_wait<0>();
      if (lane == 0) mbar_arrive(smem_u32(&kempty[slot]));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(sc[i]) :: "memory");

    // scale, softcap and mask the fp32 scores; online softmax per row
    // (sc[4 j + 2 h + v]: row 16 warp + g + 8 h, key k0 + 8 j + 2 qd + v)
    const bool whole = k0 >= all_lo && k0 + KT <= all_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * qd + (e & 1), qp = qpos[e >> 1];
        float x = sc[4 * j + e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (!whole) {
          bool ok = kpos < p.Tk;
          if (p.causal) ok = ok && kpos <= qp;
          if (p.window > 0) ok = ok && kpos > qp - p.window;
          x = ok ? x : NEG;
        }
        sc[4 * j + e] = x;
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = expf(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j + 2 * h] = expf(sc[4 * j + 2 * h] - mx);
        sc[4 * j + 2 * h + 1] = expf(sc[4 * j + 2 * h + 1] - mx);
        sum += sc[4 * j + 2 * h] + sc[4 * j + 2 * h + 1];
      }
      l[h] = l[h] * corr[h] + sum;      // this lane's share of the row
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j] *= corr[0]; o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1]; o[4 * j + 3] *= corr[1];
    }
    // P = P_hi + P_lo as register A fragments, keys 16 kb .. 16 kb + 15
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const float* s0 = sc + 8 * kb;
      split_pair<T>(s0[0], s0[1], ph[kb][0], pl[kb][0]);
      split_pair<T>(s0[2], s0[3], ph[kb][1], pl[kb][1]);
      split_pair<T>(s0[4], s0[5], ph[kb][2], pl[kb][2]);
      split_pair<T>(s0[6], s0[7], ph[kb][3], pl[kb][3]);
    }
    // O += P V on this slice's columns
    const int slot = vit % p.vs;
    mbar_wait(smem_u32(&vfull[slot]), (vit / p.vs) & 1);
    ++vit;
    fence_async_smem();
    const uint32_t sv = vs0 + slot * VST;
    hgemm::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t dv = sw128_desc(sv + 2048 * kb, KT * 128, 1024);
      wg_pv<DV, T>(o, ph[kb], dv);
      wg_pv<DV, T>(o, pl[kb], dv);
    }
    hgemm::wgmma_commit();
    hgemm::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(smem_u32(&vempty[slot]));
  }
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) asm volatile("" : "+f"(o[i]) :: "memory");

  // This block's partial over its tiles: (m, l, O) of its 64 rows, staged
  // over the rings (every copy into them has been consumed).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  named_sync(2);
  const int r_a = 16 * warp + g;
  if (qd == 0) {
    part[r_a] = m[0]; part[r_a + 8] = m[1];
    part[ROWS + r_a] = l[0]; part[ROWS + r_a + 8] = l[1];
  }
  float* const po = part + 2 * ROWS;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int c = 8 * j + 2 * qd;
    *reinterpret_cast<float2*>(po + r_a * LDO + c) = make_float2(o[4 * j],
                                                                 o[4 * j + 1]);
    *reinterpret_cast<float2*>(po + (r_a + 8) * LDO + c) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (CL > 1) cluster.sync();
  else named_sync(2);

  // Rows [rank R, rank R + R) merged over the cluster's partials in rank
  // order, four columns at a time, and stored.
  const int R = ROWS / CL, live = min(p.d - s * DV, DV);
  T* const og = static_cast<T*>(p.o);
  for (int e = tid; e < R * (DV / 4); e += 128) {
    const int row = rank * R + e / (DV / 4), c = (e % (DV / 4)) * 4;
    const int i = i0 + row / p.pg;
    if (c >= live || i >= p.Tq) continue;
    float mb[MAX_CLUSTER], lb[MAX_CLUSTER];
    float4 ab[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) {
        const float* pr = CL > 1 ? cluster.map_shared_rank(part, r) : part;
        mb[r] = pr[row];
        lb[r] = pr[ROWS + row];
        ab[r] = *reinterpret_cast<const float4*>(pr + 2 * ROWS + row * LDO + c);
      }
    float mm = NEG;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) mm = fmaxf(mm, mb[r]);
    float ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) {
        const float f = expf(mb[r] - mm);
        ls += lb[r] * f;
        a.x += ab[r].x * f; a.y += ab[r].y * f;
        a.z += ab[r].z * f; a.w += ab[r].w * f;
      }
    ls = fmaxf(ls, 1e-37f);
    T* out = og + ((long long)(b * p.Tq + i) * p.H + h0 + row % p.pg) * p.d +
             s * DV + c;
    if (p.vec_o && c + 4 <= live) {
      *reinterpret_cast<uint2*>(out) =
          make_uint2(Pair<T>::make(a.x / ls, a.y / ls),
                     Pair<T>::make(a.z / ls, a.w / ls));
    } else {
      const float v4[4] = {a.x / ls, a.y / ls, a.z / ls, a.w / ls};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < live) st1(out + k, v4[k]);
    }
  }
  if (CL > 1) cluster.sync();           // peers stop reading our partial
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The instance width of a slice of w columns: the narrowest of WIDTHS.
inline int slice_width(int w) {
  for (int x : WIDTHS)
    if (w <= x) return x;
  return 0;
}

// A call's launch: its instance (dv), column slices, query heads a row
// tile packs (pg), the grid, ring depths, blocks an SM, dynamic shared
// memory and load path.
struct Plan {
  int dv, slices, pg, nrt, nz, cluster, ks, vs, bps, smem, load, box_rows;
};

// The plan of a call on `sms` SMs: d the head dim, align the bytes every
// operand row sits on (16, 8, 4 or 2: the bases and the row's length),
// page 0 for dense K / V; cluster, stages the caller's blocks a cluster (1,
// 2, 4) and V tiles in flight (1, 2), 0, 0 for the call's own. False where
// no instance holds it: a head dim under 1 or whose Q tile leaves no room
// for a K chunk and a V tile, a grid axis past 65535, query heads not a
// multiple of the kv heads, a caller's plan the kernel cannot run.
inline bool plan(int B, int Tq, int Tk, int H, int KVH, int d, int q_offset,
                 int causal, int window, int page, int align, int sms,
                 int cluster, int stages, Plan& pl) {
  if (d < 1 || B < 0 || Tq < 0 || KVH <= 0 || H % KVH || sms < 1)
    return false;
  const bool own = cluster == 0 && stages == 0;
  if (!own && (cluster < 1 || cluster > MAX_CLUSTER ||
               (cluster & (cluster - 1)) != 0 || stages < 1 ||
               stages > VS_MAX))
    return false;
  pl = Plan{};
  pl.slices = cdiv(d, SLICE);
  pl.dv = slice_width(cdiv(d, pl.slices));
  const int G = H / KVH;
  pl.pg = 1;
  while (pl.pg < ROWS && G % (2 * pl.pg) == 0) pl.pg *= 2;
  const int rp = ROWS / pl.pg;
  pl.nrt = cdiv(Tq, rp);
  const long long nz = (long long)pl.slices * (G / pl.pg) * KVH * B;
  if (pl.nrt > 65535 || nz > 65535) return false;
  pl.nz = (int)nz;
  // load path
  const bool tma_page = page % 8 == 0 && (page % KT == 0 || KT % page == 0);
  pl.load = align >= 16 ? (page == 0 || tma_page ? LOAD_TMA : LOAD_CP16)
            : align >= 4 ? LOAD_CP4 : LOAD_ELEM;
  pl.box_rows = page > 0 && page < KT ? page : KT;
  // shared memory: Q resident, then the K ring and the V ring; the
  // partial (m, l, O) staged over them after the loop
  const int nch = cdiv(d, 64), dvb = cdiv(pl.dv, 64);
  const long long qb = (long long)nch * CHUNK, vst = (long long)dvb * CHUNK;
  const long long part = (2LL * ROWS + (long long)ROWS * (pl.dv + 8)) * 4;
  pl.smem = 0;
  for (int bps = blocks_per_sm(pl.dv); bps >= 1 && pl.smem == 0; --bps) {
    const long long rem = (bps == 2 ? SMEM_TWO : SMEM_ONE) - 1024 - qb;
    if (rem < vst + CHUNK) continue;
    int vs = rem >= 2 * vst + (nch < 4 ? nch : 4) * CHUNK ? 2 : 1;
    if (!own) {
      if (rem < stages * vst + CHUNK) continue;
      vs = stages;
    }
    long long ks = (rem - vs * vst) / CHUNK;
    ks = ks < KS_MAX ? ks : KS_MAX;
    if (qb + ks * CHUNK + vs * vst < part) continue;
    pl.bps = bps;
    pl.vs = vs;
    pl.ks = (int)ks;
    pl.smem = (int)(1024 + qb + ks * CHUNK + vs * vst);
  }
  if (pl.smem == 0) return false;
  if (!own) {
    pl.cluster = cluster;
    return true;
  }
  // blocks a cluster: the busiest row tile's key tiles, doubled while the
  // grid leaves room for it
  int most = 0;
  for (int rt = 0; rt < pl.nrt; ++rt) {
    const int p0 = q_offset + rt * rp;
    const int p1 = q_offset + (rt * rp + rp < Tq ? rt * rp + rp : Tq) - 1;
    int lo, hi;
    tile_keys(p0, p1, Tk, causal, window, lo, hi);
    if (hi > lo) {
      const int n = cdiv(hi, KT) - lo / KT;
      most = n > most ? n : most;
    }
  }
  const long long base = (long long)pl.nrt * pl.nz;
  pl.cluster = 1;
  while (pl.cluster < MAX_CLUSTER && 2 * pl.cluster <= most &&
         base * pl.cluster * 2 <= (long long)sms * pl.bps)
    pl.cluster *= 2;
  return true;
}

// The plan as the C plan functions report it, 12 fields (attention.cuh's
// order): blocks a cluster, V tiles in flight, the grid (x the cluster's
// blocks, y row tiles, z slices x head groups x kv heads x sequences),
// threads, dynamic shared memory, the instance width, column slices, query
// rows a block, K ring slots, load path (0 TMA, 1 cp.async 16 bytes, 2
// cp.async 4 bytes, 3 element copies).
inline void plan_array(const Plan& pl, long long* out) {
  const long long a[12] = {pl.cluster, pl.vs, pl.cluster, pl.nrt, pl.nz,
                           THREADS, pl.smem, pl.dv, pl.slices, ROWS,
                           pl.ks, pl.load};
  for (int i = 0; i < 12; ++i) out[i] = a[i];
}

inline int sm_count() { return hgemm::sm_count(); }

// The largest of 16, 8, 4 and 2 that divides every pointer and a row's
// d * 2 bytes.
inline int row_align(int d, const void* a, const void* b, const void* c,
                     const void* o) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(o) | (uintptr_t)(2 * d);
  return bits & 15 ? (bits & 7 ? (bits & 3 ? 2 : 4) : 8) : 16;
}

// A tensor map of a 16-bit tensor of `rank` dims (innermost first), its
// strides in elements for dims 1.., read in boxes `box`, 128-byte swizzle.
template <typename T>
bool tensor_map(const void* ptr, int rank, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box,
                CUtensorMap& out) {
  const hgemm::EncodeTiled fn = hgemm::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    if (i > 0) gs[i - 1] = strides[i - 1] * 2;
  }
  return fn(&out, std::is_same<T, bf16>::value
                      ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            rank, const_cast<void*>(ptr), gd, gs, bx, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DV, typename T>
cudaError_t launch_dv(const Args& a, const Plan& pl, const CUtensorMap& mq,
                      const CUtensorMap& mk, const CUtensorMap& mv,
                      cudaStream_t s) {
  auto kernel = flash_wg_kernel<DV, T>;
  static bool configured = false;     // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ONE);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, pl.nrt, pl.nz);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, mq, mk, mv);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, const Plan& pl, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv,
                     cudaStream_t s) {
  switch (pl.dv) {
#define WG_DV(N) \
    case N: return launch_dv<N, T>(a, pl, mq, mk, mv, s);
    WG_DV(16) WG_DV(32) WG_DV(48) WG_DV(64) WG_DV(80) WG_DV(96) WG_DV(112)
    WG_DV(128) WG_DV(160) WG_DV(192) WG_DV(224) WG_DV(256)
#undef WG_DV
    default: return cudaErrorInvalidValue;
  }
}

// One call: dense K / V (B, Tk, KVH, d) when table is null, else the
// pools (KVH, npool, page, d) through the table (B = 1); cluster, stages
// the caller's plan (0, 0: the call's own).
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* table, int B, int Tq, int Tk, int H, int KVH,
                   int d, int q_offset, int causal, int window, int npool,
                   int page, float softcap, float scale, int cluster,
                   int stages, cudaStream_t s) {
  const bool paged = table != nullptr;
  Plan pl;
  if (!plan(B, Tq, Tk, H, KVH, d, q_offset, causal, window, paged ? page : 0,
            row_align(d, q, k, v, o), sm_count(), cluster, stages, pl))
    return cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return cudaSuccess;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.table = table;
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.KVH = KVH; a.G = H / KVH; a.pg = pl.pg;
  a.q_offset = q_offset; a.causal = causal; a.window = window;
  a.paged = paged; a.npool = npool; a.page = paged ? page : 1;
  a.d = d; a.nch = cdiv(d, 64); a.ksteps = cdiv(d, 16);
  a.slices = pl.slices; a.load = pl.load; a.box_rows = pl.box_rows;
  a.ks = pl.ks; a.vs = pl.vs;
  a.vec_o = (reinterpret_cast<uintptr_t>(o) & 7) == 0 && d % 4 == 0;
  a.softcap = softcap; a.scale = scale;
  CUtensorMap mq{}, mk{}, mv{};
  if (pl.load == LOAD_TMA) {
    const uint64_t hd = (uint64_t)H * d;
    const uint64_t qdims[4] = {(uint64_t)d, (uint64_t)H, (uint64_t)Tq,
                               (uint64_t)B};
    const uint64_t qstr[3] = {(uint64_t)d, hd, hd * Tq};
    const uint32_t qbox[4] = {64, (uint32_t)pl.pg,
                              (uint32_t)(ROWS / pl.pg), 1};
    bool ok = tensor_map<T>(q, 4, qdims, qstr, qbox, mq);
    if (paged) {
      const uint64_t dims[2] = {(uint64_t)d,
                                (uint64_t)KVH * npool * page};
      const uint64_t str[1] = {(uint64_t)d};
      const uint32_t box[2] = {64, (uint32_t)pl.box_rows};
      ok = ok && tensor_map<T>(k, 2, dims, str, box, mk) &&
           tensor_map<T>(v, 2, dims, str, box, mv);
    } else {
      const uint64_t kd = (uint64_t)KVH * d;
      const uint64_t dims[4] = {(uint64_t)d, (uint64_t)KVH, (uint64_t)Tk,
                                (uint64_t)B};
      const uint64_t str[3] = {(uint64_t)d, kd, kd * Tk};
      const uint32_t box[4] = {64, 1, KT, 1};
      ok = ok && tensor_map<T>(k, 4, dims, str, box, mk) &&
           tensor_map<T>(v, 4, dims, str, box, mv);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  return dispatch<T>(a, pl, mq, mk, mv, s);
}

}  // namespace attn_wg

// ---------------------------------------------------------------------------
// C interface, attention.cuh's entry points for the element type the unit
// names (ATTENTION_WG_ELT, its dtype code ATTENTION_WG_DT: 1 bf16, 2 fp16);
// a call of another dtype is cudaErrorInvalidValue
// ---------------------------------------------------------------------------
#ifdef ATTENTION_WG_ELT
// flash_attention: q (B, Tq, H, D), k / v (B, Tk, KVH, D), queries
// right-aligned to the keys. cluster, stages: the caller's plan (blocks a
// cluster 1, 2 or 4; V tiles in flight 1 or 2), 0, 0 for the call's own.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
    int H, int KVH, int D, int causal, int window, float softcap, float scale,
    int dtype, void* stream, int cluster, int stages) {
  if (dtype != ATTENTION_WG_DT) return (int)cudaErrorInvalidValue;
  return (int)attn_wg::launch<ATTENTION_WG_ELT>(
      q, k, v, o, nullptr, B, Tq, Tk, H, KVH, D, Tk - Tq, causal, window, 0,
      1, softcap, scale, cluster, stages, static_cast<cudaStream_t>(stream));
}

// The geometry flash_attention_launch runs for these arguments, the
// caller's (cluster, stages) and rows on `align` bytes (16: whole aligned
// 16-byte words), as attn_wg::plan_array; launches nothing.
extern "C" int flash_attention_plan(int B, int Tq, int Tk, int H, int KVH,
                                    int D, int causal, int window, int dtype,
                                    int cluster, int stages, int align,
                                    long long* plan) {
  attn_wg::Plan pl;
  if (dtype != ATTENTION_WG_DT ||
      !attn_wg::plan(B, Tq, Tk, H, KVH, D, Tk - Tq, causal, window, 0, align,
                     attn_wg::sm_count(), cluster, stages, pl))
    return (int)cudaErrorInvalidValue;
  attn_wg::plan_array(pl, plan);
  return 0;
}

// paged_prefill_attention: the queries at [start, start + Tq), keys [0,
// start + Tq) through the block table; its own plan.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    void* o, int Tq, int start, int H, int KVH, int D, int npool, int page,
    int window, float softcap, float scale, int dtype, void* stream) {
  if (dtype != ATTENTION_WG_DT || table == nullptr || page < 1)
    return (int)cudaErrorInvalidValue;
  return (int)attn_wg::launch<ATTENTION_WG_ELT>(
      q, k_pool, v_pool, o, table, 1, Tq, start + Tq, H, KVH, D, start, 1,
      window, npool, page, softcap, scale, 0, 0,
      static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill_plan(int Tq, int start, int H, int KVH, int D,
                                  int window, int dtype, int page, int align,
                                  long long* plan) {
  attn_wg::Plan pl;
  if (dtype != ATTENTION_WG_DT || page < 1 ||
      !attn_wg::plan(1, Tq, start + Tq, H, KVH, D, start, 1, window, page,
                     align, attn_wg::sm_count(), 0, 0, pl))
    return (int)cudaErrorInvalidValue;
  attn_wg::plan_array(pl, plan);
  return 0;
}
#endif  // ATTENTION_WG_ELT
