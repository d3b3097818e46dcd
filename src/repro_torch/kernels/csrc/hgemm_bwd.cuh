// The engine GEMM's two backward products for Hopper, 16-bit operands
// (bf16 or fp16), fp32 sums, the output in the operand's dtype: a
// persistent, stream-K wgmma kernel (gemm_bwd.cu, gemm_bwd16.cu).
//
// Replaces the gradient of src/repro/kernels/gemm.py:81 gemm_os (its
// pallas_call :105), which JAX leaves to XLA's dot: the training path's
// dA = dC B^T and dB = A^T dC (kernels/gemm.py grad_a / grad_b). The
// forward kernels (hgemm.cuh) ran them until now.
//
// What bounds it on the H100: at gemma3-1b's training shapes (4 x 1024
// token rows, d 1152, d_ff 6912, vocab 262144) the products do 2.4 G to
// 2.5 T multiply-adds on a few MB to 2.1 GB of operands: past the card's
// 295 operations a byte, so the tensor-core rate bounds each (989
// TFLOP/s). What kept the forward kernel from it here: wave quantisation
// (160 tiles of 128 x 256 on 132 SMs for every dA at N = 1152, a half-
// empty column tile, no K split beyond one wave of clusters), no overlap
// between one tile's epilogue and the next's loads, and a copy of A^T or
// dC^T before every dB. The design:
//   - Operands read in place: A K-major (dC row-major) or M-major (A^T of
//     the saved row-major activation), B K-major (a row-major weight read
//     as its transpose) or N-major (the tied table, dC), each by TMA boxes
//     over its own buffer into 128-byte swizzled stages, the wgmma
//     descriptors' transpose bits taking the MN-major ones. No copy.
//   - Tiles 128 x BN, BN 192 or 128 (pick_bn; 192 at N = 1152: six whole
//     column tiles, not 4.5 of 256). 256 columns, tried too, leave room
//     for 3 stages beside the staged output tile and ran 0.72-0.83 us a k
//     step against 192's 0.49-0.52 (PERF.md).
//   - One block an SM walks a fixed list of work units: whole waves of
//     tiles data-parallel (block g takes tiles g, g + G, ...: a wave's
//     tiles share their operands' k slices in L2), then each of the R
//     remaining tiles cut into s = G / R equal k ranges of at least
//     MIN_SEG k steps, one a block (stream-K, each share within one k step
//     of the others), so the blocks that run together sit at s k offsets
//     and still share the operands' k slices in L2: spreading every tile
//     over all SMs at arbitrary offsets, tried first, streamed each
//     block's operands from device memory and took the unembedding's dA
//     from 4.64 to 7.53 ms on an H100 (PERF.md). A share never crosses a
//     tile, so where R does not divide G some SMs idle (dB of wo: 48
//     tiles in 2 shares, 96 blocks).
//   - A split tile's partials meet in the calling stream's workspace: the
//     blocks after the first store theirs (fp32, a warp's 512 bytes
//     contiguous) and raise their flag; the block holding the tile's first
//     k steps, which reaches it last, waits for the flags, adds the
//     partials in k order onto its own and stores the tile; each flag is
//     put back to 0, so a call needs no memset and a rerun is bit-equal.
//   - Warp-specialised: a producer warpgroup (one thread issuing TMA into
//     a ring of 4 stages at 192 columns, 5 at 128, beside the staged
//     output tile: about 210 KB) and two consumer warpgroups on
//     wgmma, each 64 rows of the tile. A warp's registers come from its
//     SM quarter's 16384, so three warps a quarter (288 or 384 threads)
//     hold at most 168 registers a thread at launch; setmaxnreg then moves
//     registers from the producer (40) to the consumers (232), which hold
//     a 64 x 192 fp32 accumulator (96 registers) and the merge of a split
//     tile's partials (a float4 at a time). The producer runs ahead into
//     the next unit while the consumers store the last one, so a tile's
//     epilogue overlaps the next tile's loads; the first wgmma of a unit
//     starts its sum (scale-d 0), so nothing is zeroed between units.
//   - The epilogue stages the tile in 16-bit pairs in shared memory (the
//     128-byte swizzled layout, conflict-free) and one TMA store a block
//     writes it while the consumers start the next unit. Stores straight
//     from the fragments, tried first, took 3-8 us a tile, as long as a
//     short tile's main loop (tools/hgemm_bwd_phases.py, PERF.md).
// Ragged M, N and K are TMA's out-of-bounds zeros and its store's
// clipping. The plan depends on the shape and the SM count alone, so a
// rerun sums every output in the same order.

#pragma once

#include "hgemm.cuh"

namespace hgemm_bwd {

using hgemm::bf16;
using hgemm::ceil_div;

constexpr int BM = 128;             // tile rows: two consumer warpgroups
constexpr int BK = 64;              // k a stage (128 bytes of 16-bit k)
constexpr int THREADS = 384;        // 2 consumer warpgroups + a producer
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMERS = 256;
// k steps a stream-K share holds at least; 8, tried, was slower at every
// product it re-planned (dB of wk at K = 4096: 7 shares, 0.61 us a k step
// against 4 shares' 0.44, 22.5 us against 21.0; PERF.md)
constexpr int MIN_SEG = 16;
constexpr int MAX_FLAGS = hgemm::MAX_TICKETS;   // flag words ahead of partials

// ring depth: as many (BM + BN) x 64 stages as fit in 220 KB beside the
// BM x BN 16-bit tile staged for the TMA store, at most 8
constexpr int stages(int bn) {
  return (220 * 1024 - BM * bn * 2) / ((BM + bn) * BK * 2) < 8
             ? (220 * 1024 - BM * bn * 2) / ((BM + bn) * BK * 2) : 8;
}
constexpr int smem_bytes(int bn) {
  return stages(bn) * (BM + bn) * BK * 2 + BM * bn * 2 + 1024;
}
// the ring of a BN-wide tile (evaluated on the host side of the build)
template <int BN>
struct Ring {
  static constexpr int ST = stages(BN);
};

struct Plan {
  int bn, stages, smem;
  int tiles_m, tiles_n, ksteps;
  long long tiles, dp_tiles, sk_tiles;
  int splits, sk_blocks, grid;   // splits: the stream-K shares of a tile
  long long ws_words;   // flags then partials, 0 where no tile is split
};

// The column tile: 192, or 128 where 192's padded columns cost more than
// 128's at the 5 : 4 time a column the card gave them (0.42 us a k step of
// 128 columns, 0.49 of 192 on an H100; PERF.md).
inline int pick_bn(int n) {
  return (long long)ceil_div(n, 128) * 128 * 5 <
                 (long long)ceil_div(n, 192) * 192 * 4
             ? 128 : 192;
}

// The plan of an (M, N, K) product on `sms` SMs: whole waves of G = sms
// tiles data-parallel, block g taking tiles g, g + G, ...; the R remaining
// tiles each cut into s equal k ranges, s = G / R (at most K / MIN_SEG),
// one range a block: sk_blocks = R s stream-K blocks, stream-K block b
// taking range b % s of remaining tile b / s, so the blocks that run
// together sit at only s distinct k offsets and share their operands' k
// slices in L2. (Shares at any k offset ran 0.57-0.65 us a k step against
// 0.48-0.50 even where the operands fit in L2 on an H100, PERF.md.) False
// where the kernel cannot run it (a dimension under 1, a tile count past
// 32 bits, more stream-K blocks than flags).
inline bool plan(int m, int n, int k, int sms, Plan& p) {
  if (m < 1 || n < 1 || k < 1 || sms < 1) return false;
  p = Plan{};
  p.bn = pick_bn(n);
  p.stages = stages(p.bn);
  p.smem = smem_bytes(p.bn);
  p.tiles_m = ceil_div(m, BM);
  p.tiles_n = ceil_div(n, p.bn);
  p.ksteps = ceil_div(k, BK);
  p.tiles = (long long)p.tiles_m * p.tiles_n;
  const long long G = sms;
  if (p.tiles >= (1LL << 31)) return false;
  p.dp_tiles = p.tiles / G * G;
  p.sk_tiles = p.tiles - p.dp_tiles;
  long long s = p.sk_tiles > 0 ? G / p.sk_tiles : 1;
  s = s < p.ksteps / MIN_SEG ? s : p.ksteps / MIN_SEG;
  p.splits = (int)(s > 1 ? s : 1);
  p.sk_blocks = (int)(p.sk_tiles * p.splits);
  if (p.sk_blocks > MAX_FLAGS) return false;
  p.grid = p.dp_tiles > 0 ? sms : p.sk_blocks;
  p.ws_words = p.splits > 1
                   ? MAX_FLAGS + (long long)p.sk_blocks * BM * p.bn
                   : 0;
  return true;
}

struct Args {
  const void* A;      // A(m, k): A[m * lda + k] (K-major) or A[k * lda + m]
  const void* B;      // B(k, n): B[n * ldb + k] (K-major) or B[k * ldb + n]
  void* C;            // C[m * ldc + n]
  int M, N, K;
  long long ldc;
  int tiles_m, tiles_n, ksteps;
  int dp_tiles, splits, sk_blocks;
  int* flags;         // splits > 1: one a stream-K block, 0 between calls
  float* part;        // splits > 1: a BM x BN partial a stream-K block
};

// A block's work, in order: its data-parallel tiles, then its stream-K
// share. A unit is k steps [lo, hi) of one tile.
struct Unit {
  int tile, lo, hi;
};

// The first k step of range j of a tile's s.
__device__ __forceinline__ int share_start(int j, int s, int ksteps) {
  return (int)((long long)j * ksteps / s);
}

struct Walk {
  int next_dp, dp_tiles, step, ksteps;
  bool sk;            // the stream-K share is still to come
  Unit share;
  __device__ __forceinline__ Walk(const Args& p, int g, int G) {
    next_dp = g;
    dp_tiles = p.dp_tiles;
    step = G;
    ksteps = p.ksteps;
    sk = g < p.sk_blocks;
    const int j = g % p.splits;
    share.tile = p.dp_tiles + g / p.splits;
    share.lo = share_start(j, p.splits, p.ksteps);
    share.hi = share_start(j + 1, p.splits, p.ksteps);
  }
  __device__ __forceinline__ bool next(Unit& u) {
    if (next_dp < dp_tiles) {
      u.tile = next_dp;
      u.lo = 0;
      u.hi = ksteps;
      next_dp += step;
      return true;
    }
    if (!sk) return false;
    sk = false;
    u = share;
    return true;
  }
};

// d (64 x 128 fp32) (+)= A (64 x 16) B (16 x 128); TA / TB: A / B
// MN-major (the descriptors' transpose bits); scale_d 0 starts the sum.
#define BW_WGMMA_128(TY)                                             \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %66, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "  \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, %67, %68;\n"   \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)  \
      : "memory")

// d (64 x 192 fp32) (+)= A (64 x 16) B (16 x 192); TA / TB: A / B
// MN-major (the descriptors' transpose bits); scale_d 0 starts the sum.
#define BW_WGMMA_192(TY)                                             \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %98, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "  \
      "%56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, "  \
      "%72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, "  \
      "%88, %89, %90, %91, %92, %93, %94, %95}, "  \
      "%96, %97, p, 1, 1, %99, %100;\n"   \
      "}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),  \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),  \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),  \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),  \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),  \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])  \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB)  \
      : "memory")

template <typename Elt, int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bw(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  constexpr bool B16 = std::is_same<Elt, bf16>::value;
  if constexpr (BN == 128) {
    if constexpr (B16) BW_WGMMA_128("bf16"); else BW_WGMMA_128("f16");
  } else {
    static_assert(BN == 192, "tiles of 128 or 192 columns");
    if constexpr (B16) BW_WGMMA_192("bf16"); else BW_WGMMA_192("f16");
  }
}
#undef BW_WGMMA_128
#undef BW_WGMMA_192

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Block: warpgroups 0 and 1 multiply (rows 64 w of the tile, all BN
// columns), warpgroup 2 produces: its first thread keeps the ring of ST
// stages full across the block's units (full / empty mbarriers, one count
// of stage fills for the whole walk), the other three warps leave after
// giving up their registers. A_MN: A is M-major (A^T of a row-major
// buffer); B_K: B is K-major (the transpose of a row-major buffer).
template <typename Elt, bool A_MN, bool B_K, int BN>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const Args p, const __grid_constant__ CUtensorMap tma_a,
           const __grid_constant__ CUtensorMap tma_b,
           const __grid_constant__ CUtensorMap tma_c) {
  constexpr int ST = Ring<BN>::ST;
  constexpr int A_BYTES = BM * BK * 2, STAGE = (BM + BN) * BK * 2;
  constexpr int FR = BN / 2;             // a consumer thread's accumulators
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];   // stage s has landed
  __shared__ __align__(8) uint64_t empty[ST];  // every consumer warp is done
  const uint32_t raw = hgemm::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t cbase = sbase + ST * STAGE;   // the staged C tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wtid = tid & 127;
  const int g = blockIdx.x, G = gridDim.x;

  if (tid == CONSUMERS) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tma_c)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tma_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tma_b)) : "memory");
    for (int i = 0; i < ST; ++i) {
      hgemm::mbar_init(hgemm::smem_u32(&full[i]), 1);
      hgemm::mbar_init(hgemm::smem_u32(&empty[i]), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (tid != CONSUMERS) return;
    Walk w(p, g, G);
    Unit u;
    int it = 0;
    while (w.next(u)) {
      int mt, nt;
      hgemm::tile_coords(u.tile, p.tiles_m, p.tiles_n, 0, mt, nt);
      const int m0 = mt * BM, n0 = nt * BN;
      for (int s = u.lo; s < u.hi; ++s, ++it) {
        const int stage = it % ST;
        if (it >= ST)
          hgemm::mbar_wait(hgemm::smem_u32(&empty[stage]),
                           ((it / ST) - 1) & 1);
        const uint32_t bar = hgemm::smem_u32(&full[stage]);
        const uint32_t sa = sbase + stage * STAGE, sb = sa + A_BYTES;
        const int k0 = s * BK;
        hgemm::mbar_expect(bar, STAGE);
        if (A_MN) {
          hgemm::tma_2d(sa, &tma_a, m0, k0, bar);
          hgemm::tma_2d(sa + BK * 128, &tma_a, m0 + 64, k0, bar);
        } else {
          hgemm::tma_2d(sa, &tma_a, k0, m0, bar);
        }
        if (B_K) {
          hgemm::tma_2d(sb, &tma_b, k0, n0, bar);
        } else {
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            hgemm::tma_2d(sb + h * (BK * 128), &tma_b, n0 + 64 * h, k0, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  float acc[FR];
#pragma unroll
  for (int i = 0; i < FR; ++i) acc[i] = 0.f;
  Walk w(p, g, G);
  Unit u;
  int it = 0;
  while (w.next(u)) {
    int mt, nt;
    hgemm::tile_coords(u.tile, p.tiles_m, p.tiles_n, 0, mt, nt);
    const int m0 = mt * BM, n0 = nt * BN;
    const int n = u.hi - u.lo;
    for (int i = 0; i < n; ++i, ++it) {
      const int stage = it % ST;
      hgemm::mbar_wait(hgemm::smem_u32(&full[stage]), (it / ST) & 1);
      const uint32_t sa = sbase + stage * STAGE + wg * (BK * 128);
      const uint32_t sb = sbase + stage * STAGE + A_BYTES;
      hgemm::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        // K-major: 32 bytes a k16 step; MN-major: 16 k rows of 128 bytes,
        // the next 64 columns a stage's 64 k rows on
        const uint64_t da =
            A_MN ? hgemm::sw128_desc(sa + 2048 * j, BK * 128, 1024)
                 : hgemm::sw128_desc(sa + 32 * j, 16, 1024);
        const uint64_t db =
            B_K ? hgemm::sw128_desc(sb + 32 * j, 16, 1024)
                : hgemm::sw128_desc(sb + 2048 * j, BK * 128, 1024);
        wgmma_bw<Elt, BN, A_MN ? 1 : 0, B_K ? 0 : 1>(acc, da, db,
                                                     i > 0 || j > 0);
      }
      hgemm::wgmma_commit();
      hgemm::wgmma_wait<1>();          // the product of step i - 1 is done
      if (i > 0 && lane == 0)
        hgemm::mbar_arrive(hgemm::smem_u32(&empty[(it - 1) % ST]));
    }
    hgemm::wgmma_wait<0>();
    if (lane == 0) hgemm::mbar_arrive(hgemm::smem_u32(&empty[(it - 1) % ST]));
#pragma unroll
    for (int i = 0; i < FR; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");

    if (u.lo > 0) {
      // a later share of a split tile: its partial to this block's slot,
      // then its flag (the release after every consumer's fence)
      hgemm::store_partial<FR, CONSUMERS>(
          acc, p.part + (long long)g * BM * BN + 4 * tid);
      __threadfence();
      consumer_sync();
      if (tid == 0) {
        __threadfence();
        atomicExch(p.flags + g, 1);
      }
      continue;
    }
    if (u.hi < p.ksteps) {
      // the first share of a split tile, which this block reaches last:
      // blocks g + 1 .. g + S - 1 hold the rest, in k order
      const int S = p.splits;
      if (tid == 0) {
        for (int c = 1; c < S; ++c) {
          while (load_acquire(p.flags + g + c) == 0) __nanosleep(64);
          p.flags[g + c] = 0;
        }
      }
      consumer_sync();
      __threadfence();
      // the later shares' partials onto this one's, in k order: a float4
      // at a time (few registers beside the accumulator), a share's loads
      // all in flight together
      const float4* part = reinterpret_cast<const float4*>(
          p.part + (long long)g * BM * BN + 4 * tid);
#pragma unroll 1
      for (int c = 1; c < S; ++c) {
        const float4* ps = part + (long long)c * (BM * BN / 4);
#pragma unroll
        for (int i = 0; i < FR / 4; ++i) {
          const float4 v = __ldcg(ps + i * CONSUMERS);
          acc[4 * i] += v.x;
          acc[4 * i + 1] += v.y;
          acc[4 * i + 2] += v.z;
          acc[4 * i + 3] += v.w;
        }
      }
    }
    // acc[4j + 2h + v]: C(64 wg + 16 (warp % 4) + lane / 4 + 8h, 8j + 2
    // (lane % 4) + v) of the tile, staged as 16-bit pairs in the layout
    // TMA stores with 128-byte swizzle (BN / 64 blocks of 64 rows x 128
    // bytes a warpgroup: conflict-free), then stored by one TMA a block
    // while the consumers go on to the next unit. The ragged edge is the
    // store's own clipping.
    const uint32_t cw = cbase + wg * (BN / 64) * 8192;
    if (wtid == 0)       // the last unit's store has read the staging tile
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(wg);
    {
      const int r = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
          const uint32_t at = cw + (j >> 3) * 8192 + rr * 128 +
                              (((j & 7) ^ (rr & 7)) << 4) + 4 * (lane & 3);
          asm volatile("st.shared.u32 [%0], %1;\n"
                       :: "r"(at), "r"(hgemm::pack2<Elt>(
                              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]))
                       : "memory");
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    if (wtid == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        asm volatile(
            "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
            " [%0, {%1, %2}], [%3];\n"
            :: "l"(reinterpret_cast<uint64_t>(&tma_c)), "r"(n0 + 64 * b),
               "r"(m0 + 64 * wg), "r"(cw + b * 8192)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (wtid == 0)         // the block's shared memory outlives its stores
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename Elt, bool A_MN, bool B_K, int BN>
cudaError_t launch_kernel(const Args& a, const Plan& pl, const CUtensorMap& ta,
                          const CUtensorMap& tb, const CUtensorMap& tc,
                          cudaStream_t s) {
  auto kernel = bwd_kernel<Elt, A_MN, B_K, BN>;
  static bool configured = false;
  const cudaError_t e = hgemm::allow_smem(kernel, smem_bytes(BN), configured);
  if (e != cudaSuccess) return e;
  kernel<<<pl.grid, THREADS, smem_bytes(BN), s>>>(a, ta, tb, tc);
  return cudaGetLastError();
}

template <typename Elt, bool A_MN, bool B_K>
cudaError_t dispatch_bn(const Args& a, const Plan& pl, const CUtensorMap& ta,
                        const CUtensorMap& tb, const CUtensorMap& tc,
                        cudaStream_t s) {
  if (pl.bn == 128)
    return launch_kernel<Elt, A_MN, B_K, 128>(a, pl, ta, tb, tc, s);
  return launch_kernel<Elt, A_MN, B_K, 192>(a, pl, ta, tb, tc, s);
}

// One product C (M, N, row stride ldc) = A (M, K) B (K, N), fp32 sums,
// rounded to Elt (bf16 or __half). a_mn: A(m, k) = A[k * lda + m], else
// A[m * lda + k]; b_k: B(k, n) = B[n * ldb + k], else B[k * ldb + n].
// A, B and C need rows of whole 16-byte words on 16-byte boundaries
// (tensor maps); the caller routes others elsewhere. workspace: the
// plan's ws_words 4-byte words (flags, then partials), owned by the
// calling stream, flags 0; null where the plan needs none.
template <typename Elt>
cudaError_t launch(const Elt* A, const Elt* B, Elt* C, int m, int n, int k,
                   long long lda, long long ldb, long long ldc, int a_mn,
                   int b_k, void* workspace, cudaStream_t s) {
  Plan pl;
  if (!plan(m, n, k, hgemm::sm_count(), pl))
    return cudaErrorInvalidValue;
  if (pl.ws_words > 0 && workspace == nullptr) return cudaErrorInvalidValue;
  if (lda % 8 != 0 || ldb % 8 != 0 || ldc % 8 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(C) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap ta{}, tb{}, tc{};
  const bool maps =
      (a_mn ? hgemm::tensor_map(A, m, k, lda, 64, BK, ta)
            : hgemm::tensor_map(A, k, m, lda, BK, BM, ta)) &&
      (b_k ? hgemm::tensor_map(B, k, n, ldb, BK, pl.bn, tb)
           : hgemm::tensor_map(B, n, k, ldb, 64, BK, tb)) &&
      hgemm::tensor_map(static_cast<const Elt*>(C), n, m, ldc, 64, 64, tc);
  if (!maps) return cudaErrorInvalidValue;
  Args a{};
  a.A = A; a.B = B; a.C = C;
  a.M = m; a.N = n; a.K = k; a.ldc = ldc;
  a.tiles_m = pl.tiles_m; a.tiles_n = pl.tiles_n; a.ksteps = pl.ksteps;
  a.dp_tiles = (int)pl.dp_tiles; a.splits = pl.splits;
  a.sk_blocks = pl.sk_blocks;
  a.flags = static_cast<int*>(workspace);
  a.part = workspace ? static_cast<float*>(workspace) + MAX_FLAGS : nullptr;
  if (a_mn)
    return b_k ? dispatch_bn<Elt, true, true>(a, pl, ta, tb, tc, s)
               : dispatch_bn<Elt, true, false>(a, pl, ta, tb, tc, s);
  return b_k ? dispatch_bn<Elt, false, true>(a, pl, ta, tb, tc, s)
             : dispatch_bn<Elt, false, false>(a, pl, ta, tb, tc, s);
}

}  // namespace hgemm_bwd
