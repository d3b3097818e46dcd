// fp32 x fp32 -> fp32 GEMM for Hopper on CUDA-core FMAs: the float datapath
// of the engine GEMM in gemm.cu, C = epilogue(A @ B + D), for fp32 inputs
// (the fp32 engine config).
//
// Replaces, in src/repro/kernels/gemm.py, gemm_os (:81, pallas_call :105)
// and gemm_ws (:160, pallas_call :184) for fp32 inputs.
//
// IEEE fp32: every product is an fmaf on the CUDA cores -- no TF32, no
// split into TF32 pieces -- so the fp32 engine config keeps fp32's 24-bit
// significand; only the order of the sum differs from the plain version's.
// What bounds it on the H100: at the fp32 prefill shapes (M = 64-256 rows
// against 1-50 k columns) the CUDA-core fp32 rate, 67 TFLOP/s; at decode
// rows (M <= 16) the bytes of B. At M = 64 a 64-row tile gives N / 128
// tiles (8 for gemma3-1b's wq), so the tiles alone leave most SMs idle.
//
// The design:
//   - Block tiles of 128 x 128 (256 threads), or 64 x 128 (128 threads)
//     where those pad M less (M <= 64, the M = 64 prompt). Each thread
//     holds an 8 x 8 register micro-tile: per 4 k, 8 float4 loads of A and
//     8 of B from shared memory feed 256 FMAs.
//   - Operands by 16-byte cp.async into a 4-stage ring of BK = 16 k
//     slices: three slices are in flight while one computes, and one
//     block-wide barrier per slice.
//   - A K-major in shared memory, as it lies in device memory. B in the
//     layout it lies in: row-major (K, N) weights N-major (a thread's 8
//     columns are two float4 runs 64 apart, so a quarter warp reads 128
//     contiguous bytes), the tied unembedding's table.T K-major, never
//     copied (a thread's columns 16 apart; K-major rows are padded to 20
//     floats, so the 8 rows a quarter warp reads fall in 8 bank groups).
//   - A blocked sum: each slice's 16 products per output are summed apart
//     and then added to the running sum, so the fp32 error grows with
//     K / 16 + 16 terms, not K (one chain over mamba2-1.3b's K = 2048 left
//     outputs outside the fp32 tolerance against the plain version).
//   - Ragged M, N and K are masked in the loads: cp.async zero-fills what
//     lies outside. Operands whose rows are not 16-byte aligned load in
//     4-byte cp.async copies instead, still asynchronous.
//   - Split K where the tiles leave SMs idle or end in a thin last wave,
//     at least 4 slices (64 k) per split and at most 16 splits. Each split
//     writes its partial to the stream's workspace; the tile's last block,
//     found by a ticket, adds them in split order and stores the tile, in
//     the same launch (hgemm.cuh's store_partial / last_of_tile /
//     merge_partials: tickets are left at 0, so no memset).
//   - The epilogue stages the tile in shared memory and finishes it in one
//     compact loop (finishing the 64 values in registers unrolls the
//     activation 64 times, and fetching that code took longer than a short
//     split's main loop).
// What it does not reach: an 8 x 8 micro-tile from shared memory needs a
// quarter of a word per FMA, the H100's whole shared-memory bandwidth at
// the FMA rate, and the blocked sum holds the registers a larger
// micro-tile would need; at mamba2-1.3b's in_proj (M = 256) it takes
// 1.35x torch.matmul's time (PERF.md).
// The plan depends on the shape, B's layout and the SM count only, and
// each tile is computed the same way whatever order the blocks walk, so
// WS (weight-major tile order) equals OS bit for bit, and a rerun equals
// the first run.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "hgemm.cuh"

namespace sgemm {

constexpr int BN = 128;          // block columns
constexpr int BK = 16;           // k per ring stage
constexpr int STAGES = 4;
constexpr int LDK = BK + 4;      // floats per K-major row (80 bytes)
constexpr int LDN = BN + 4;      // floats per N-major row
constexpr int LDT = BN + 4;      // floats per row of the staged C tile
constexpr int MIN_STEPS = 4;     // stages a split walks at least
constexpr int MAX_SPLITS = 16;   // partials a tile merges at most

struct Plan {
  int bm, bn, bk, threads, stages, smem;
  int tiles_m, tiles_n, ksteps, splits;
  long long blocks;
  long long ws_words;   // workspace: tickets then partials, 0 for one split
};

template <int BM, bool TRANS_B>
struct Shape {
  static constexpr int T = BM * BN / 64;          // 8 x 8 outputs a thread
  static constexpr int TY = BM / 8, TX = BN / 8;  // thread grid (TX = 16)
  static constexpr int A_FLOATS = BM * LDK;
  static constexpr int B_FLOATS = TRANS_B ? BN * LDK : BK * LDN;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE * 4;
  static_assert(STAGES * STAGE >= BM * LDT, "the C tile must fit the ring");
};

inline int smem_bytes(int bm, int b_trans) {
  if (bm == 128)
    return b_trans ? Shape<128, true>::SMEM : Shape<128, false>::SMEM;
  return b_trans ? Shape<64, true>::SMEM : Shape<64, false>::SMEM;
}

// The plan of a call: shape, B's layout and SM count only.
//   - 128-row tiles unless 64-row ones pad M less (M <= 64, M = 129..192):
//     a 128 x 128 tile did more per SM than two 64 x 128 ones at M = 256
//     on the H100.
//   - K splits s minimizing waves(s) * (ksteps / s + 3 + s / 8): the
//     blocks' waves over the resident slots (one 256-thread block or two
//     128-thread ones per SM, by their registers) times a split's k steps
//     plus its fill and merge, in k steps. Fitted to a sweep of s on the
//     H100: mamba2-1.3b's in_proj (134 tiles, a thin second wave unsplit)
//     ran fastest at 4-8 splits, gemma3-1b's wq at M = 64 (8 tiles) at
//     12-16.
inline Plan plan(int m, int n, int k, int b_trans, int sms) {
  using hgemm::ceil_div;
  Plan p{};
  p.bm = ceil_div(m, 128) * 128 == ceil_div(m, 64) * 64 && m > 64 ? 128 : 64;
  p.bn = BN;
  p.bk = BK;
  p.threads = p.bm * BN / 64;
  p.stages = STAGES;
  p.smem = smem_bytes(p.bm, b_trans);
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(n, BN);
  p.ksteps = ceil_div(k, BK);
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  const long long slots = (long long)sms * (p.bm == 64 ? 2 : 1);
  int most = p.ksteps / MIN_STEPS;
  most = most < MAX_SPLITS ? most : MAX_SPLITS;
  if (tiles > hgemm::MAX_TICKETS) most = 1;
  int s = 1;
  double best = 0.0;
  for (int c = 1; c <= most || c == 1; ++c) {
    const double waves = (double)((tiles * c + slots - 1) / slots);
    const double cost = waves * ((double)p.ksteps / c + 3.0 + c / 8.0);
    if (c == 1 || cost < best) { best = cost; s = c; }
  }
  p.splits = s;
  p.blocks = tiles * s;
  p.ws_words = s > 1 ? hgemm::MAX_TICKETS + p.blocks * p.bm * BN : 0;
  return p;
}

struct Args {
  const float* A;    // (M, K), row stride lda
  const float* B;    // B(k, n) = B[k * ldb + n], or B[n * ldb + k] (TRANS_B)
  const float* D;    // fp32 bias, row stride ldd (0: one row), or null
  void* C;           // contiguous (M, N)
  int M, N, K;
  long long lda, ldb, ldd;
  int act;
  float out_scale;
  int vec_a, vec_b;  // rows 16-byte aligned: 16-byte copies, else 4-byte
  int ws;            // weight-major tile order
  int tiles_m, tiles_n, ksteps, splits;
  float* part;       // splits > 1: [tile][split][partial]
  int* tickets;      // splits > 1: one per tile, 0 between calls
};

// 4 consecutive floats at src, `left` of them inside the matrix (<= 0:
// none), into the 16 bytes at shared address dst, zeros past `left`: one
// 16-byte copy when vec (src 16-byte aligned), else four 4-byte copies.
// `safe` is any valid address, handed to a copy that reads nothing.
__device__ __forceinline__ void load4(uint32_t dst, const float* src, int left,
                                      int vec, const float* safe) {
  if (vec) {
    const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(bytes > 0 ? src : safe), "r"(bytes)
                 : "memory");
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst + 4 * e), "l"(e < left ? src + e : safe),
                    "r"(e < left ? 4 : 0)
                 : "memory");
}

template <int BM, bool TRANS_B, typename OutT>
__global__ void __launch_bounds__(BM * 2)
sgemm_kernel(Args p) {
  using Sh = Shape<BM, TRANS_B>;
  constexpr int T = Sh::T, TY = Sh::TY;
  extern __shared__ __align__(16) float sg_smem[];
  const int tid = threadIdx.x, ty = tid / Sh::TX, tx = tid % Sh::TX;
  const int S = p.splits, split = blockIdx.x % S, tile = blockIdx.x / S;
  int mt, nt;
  hgemm::tile_coords(tile, p.tiles_m, p.tiles_n, p.ws, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN;
  int lo, hi;
  hgemm::split_range(split, S, p.ksteps, lo, hi);
  const int steps = hi - lo;

  // One k slice (k0 = BK * step) into ring stage st.
  auto load_stage = [&](int st, int step) {
    float* as = sg_smem + st * Sh::STAGE;
    float* bs = as + Sh::A_FLOATS;
    const int k0 = step * BK;
#pragma unroll
    for (int e = tid; e < BM * BK / 4; e += T) {
      const int r = e / (BK / 4), kc = (e % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + kc;
      load4(hgemm::smem_u32(as + r * LDK + kc), p.A + gm * p.lda + gk,
            gm < p.M ? p.K - gk : 0, p.vec_a, p.A);
    }
#pragma unroll
    for (int e = tid; e < BN * BK / 4; e += T) {
      if constexpr (TRANS_B) {
        const int r = e / (BK / 4), kc = (e % (BK / 4)) * 4;
        const int gn = n0 + r, gk = k0 + kc;
        load4(hgemm::smem_u32(bs + r * LDK + kc), p.B + gn * p.ldb + gk,
              gn < p.N ? p.K - gk : 0, p.vec_b, p.B);
      } else {
        const int r = e / (BN / 4), nc = (e % (BN / 4)) * 4;
        const int gk = k0 + r, gn = n0 + nc;
        load4(hgemm::smem_u32(bs + r * LDN + nc), p.B + gk * p.ldb + gn,
              gk < p.K ? p.N - gn : 0, p.vec_b, p.B);
      }
    }
  };

  // acc[8 i + j]: C(m0 + ty + TY i, n0 + col(j)), col(j) = tx + 16 j
  // (table.T) or 4 tx + j % 4 + 64 (j / 4) (row-major B); a slice's
  // products go into part, its sum into acc (the blocked sum).
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, lo + s);
    hgemm::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    hgemm::cp_async_wait<STAGES - 2>();   // slice `it` has landed
    __syncthreads();                      // ... and slice it - 1 is read
    if (it + STAGES - 1 < steps)
      load_stage((it + STAGES - 1) % STAGES, lo + it + STAGES - 1);
    hgemm::cp_async_commit();
    const float* as = sg_smem + (it % STAGES) * Sh::STAGE;
    const float* bs = as + Sh::A_FLOATS;
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * LDK + kk);
      float b[4][8];
      if constexpr (TRANS_B) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * LDK + kk);
          b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 l =
              *reinterpret_cast<const float4*>(bs + (kk + q) * LDN + 4 * tx);
          const float4 h = *reinterpret_cast<const float4*>(
              bs + (kk + q) * LDN + 64 + 4 * tx);
          b[q][0] = l.x; b[q][1] = l.y; b[q][2] = l.z; b[q][3] = l.w;
          b[q][4] = h.x; b[q][5] = h.y; b[q][6] = h.z; b[q][7] = h.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                           : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[8 * i + j] = fmaf(av, b[q][j], part[8 * i + j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  hgemm::cp_async_wait<0>();

  if (S > 1) {
    const long long stride = (long long)T * 64;
    float* const base = p.part + (long long)tile * S * stride + 4 * tid;
    hgemm::store_partial<64, T>(acc, base + split * stride);
    if (!hgemm::last_of_tile(p.tickets + tile, S)) return;
    hgemm::merge_partials<64, T>(acc, base, stride, S, split);
  }

  // The epilogue: the tile through shared memory (the ring is free), then
  // one compact loop, consecutive threads on consecutive columns.
  __syncthreads();
  float* tile_s = sg_smem;                // [BM][LDT]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = tile_s + (ty + TY * i) * LDT;
    if constexpr (TRANS_B) {
#pragma unroll
      for (int j = 0; j < 8; ++j) row[tx + 16 * j] = acc[8 * i + j];
    } else {
      *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(
          acc[8 * i], acc[8 * i + 1], acc[8 * i + 2], acc[8 * i + 3]);
      *reinterpret_cast<float4*>(row + 64 + 4 * tx) = make_float4(
          acc[8 * i + 4], acc[8 * i + 5], acc[8 * i + 6], acc[8 * i + 7]);
    }
  }
  __syncthreads();
  OutT* C = static_cast<OutT*>(p.C);
#pragma unroll 1
  for (int e = tid; e < BM * BN; e += T) {
    const int r = m0 + e / BN, c = n0 + e % BN;
    if (r >= p.M || c >= p.N) continue;
    float v = tile_s[(e / BN) * LDT + e % BN];
    if (p.D != nullptr) v += p.D[(long long)r * p.ldd + c];
    epi::store_float(C, (long long)r * p.N + c, v, p.act, p.out_scale);
  }
}

template <int BM, bool TB, typename OutT>
cudaError_t launch_tile(const Args& a, const Plan& pl, cudaStream_t s) {
  auto kernel = sgemm_kernel<BM, TB, OutT>;
  static bool configured = false;
  const cudaError_t e =
      hgemm::allow_smem(kernel, Shape<BM, TB>::SMEM, configured);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)pl.blocks, Shape<BM, TB>::T, Shape<BM, TB>::SMEM, s>>>(a);
  return cudaGetLastError();
}

// One call. workspace: plan().ws_words 4-byte words (tickets, then
// partials), owned by the calling stream; may be null for one split.
template <typename OutT>
cudaError_t launch(const float* A, const float* B, const float* D, OutT* C,
                   int m, int n, int k, long long lda, long long ldb,
                   int b_trans, long long ldd, int act, float out_scale,
                   int ws, void* workspace, cudaStream_t s) {
  const Plan pl = plan(m, n, k, b_trans, hgemm::sm_count());
  if (pl.splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  Args a{};
  a.A = A; a.B = B; a.D = D; a.C = C;
  a.M = m; a.N = n; a.K = k;
  a.lda = lda; a.ldb = ldb; a.ldd = ldd;
  a.act = act; a.out_scale = out_scale;
  a.vec_a = lda % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  a.vec_b = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  a.ws = ws;
  a.tiles_m = pl.tiles_m; a.tiles_n = pl.tiles_n;
  a.ksteps = pl.ksteps; a.splits = pl.splits;
  a.tickets = static_cast<int*>(workspace);
  a.part = workspace ? static_cast<float*>(workspace) + hgemm::MAX_TICKETS
                     : nullptr;
  if (pl.bm == 128)
    return b_trans ? launch_tile<128, true, OutT>(a, pl, s)
                   : launch_tile<128, false, OutT>(a, pl, s);
  return b_trans ? launch_tile<64, true, OutT>(a, pl, s)
                 : launch_tile<64, false, OutT>(a, pl, s);
}

}  // namespace sgemm
