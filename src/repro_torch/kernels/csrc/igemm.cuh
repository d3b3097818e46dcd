// int8 x int8 -> int32 GEMM main loop on Hopper's int8 tensor cores,
// shared by gemm.cu (gemm_os, gemm_ws) and conv.cu (conv2d_implicit).
//
// C = epilogue(A @ B + D): A (M, K) int8 comes through a loader policy
// (a row-major matrix, or the implicit-im2col gather of an NHWC image), B
// (K, N) int8 by its strides (row-major weights, or the transpose of a
// row-major (N, K) buffer), D an int32 bias preloaded into the
// accumulator (one row broadcast, or a full (M, N) matrix), and the
// epilogue of epilogue.cuh runs once, in the store loop.
//
// Numerics: mma.sync m16n8k32 s8.s8.s32 without .satfinite, so the int32
// accumulator wraps, as the plain version's (float64-exact sum wrapped to
// int32) and the TPU kernel's int32 dot do; the sum is then order-free, so
// every tile order gives the same bits.
//
// Shared memory holds A as [m][k] and B as [n][k] (k contiguous), rows
// padded by 16 bytes: every fragment register is one aligned 32-bit load
// and the eight row groups of a warp hit distinct banks. B arrives k-major
// (K, N) from device memory; 4x4-byte blocks are transposed in registers
// (__byte_perm) on the way in. Ragged M, N and K are masked in the loads
// (zeros), never padded in memory; K need not be a multiple of 32 (the
// conv stem has K = 7*7*3 = 147).
//
// Tile orders (one kernel, chosen at launch):
//   output-stationary (gemm_os): one (BM, BN) output tile per block, A and
//     B stream through in BK = 64 slabs.
//   weight-stationary (gemm_ws): blocks walk the grid weight-major (every
//     M tile of one N strip before the next strip); a block loads its
//     (K, BN) weight strip into shared memory once, where it fits the
//     227 KB a block may hold, and keeps it across the M tiles it serves,
//     streaming only A. Where it does not fit, the strip goes in the
//     largest K slabs that do, reloaded per M tile.
//
// Simple and right first: no cp.async / TMA pipeline, no wgmma yet.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"

namespace igemm {

constexpr int BK = 64;   // k bytes per A slab
constexpr int PAD = 16;  // bytes of padding per shared row

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void set_byte(uint4& v, int e, int8_t x) {
  unsigned* w = reinterpret_cast<unsigned*>(&v);
  w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(x)) << (8 * (e & 3));
}

// A as a row-major (M, K) matrix with row stride lda.
struct MatrixA {
  const int8_t* a;
  long long lda;
  int K;
  int vec;  // lda % 16 == 0 and a 16-byte aligned
  // 16 bytes of row m (m < M), columns k..k+15, zero past K.
  __device__ __forceinline__ uint4 load16(int m, int k) const {
    const int8_t* p = a + (long long)m * lda + k;
    if (vec && k + 16 <= K) return *reinterpret_cast<const uint4*>(p);
    uint4 v = make_uint4(0, 0, 0, 0);
    for (int e = 0; e < 16 && k + e < K; ++e) set_byte(v, e, p[e]);
    return v;
  }
};

// Fill Bs[n][k] (n < BN, k < ks, row stride ldsb) with B(s0 + k, n0 + n),
// zero outside (K, N).
template <int BN, int NT>
__device__ __forceinline__ void load_b(int8_t* Bs, int ldsb,
                                       const int8_t* __restrict__ B,
                                       long long ldb, int b_trans, int vec_b,
                                       int n0, int s0, int ks, int K, int N) {
  const int tid = threadIdx.x;
  if (b_trans) {
    // B(k, n) = B[n * ldb + k]: 16-byte chunks along k, copied as they are.
    const int per_row = ks / 16;
    for (int ch = tid; ch < BN * per_row; ch += NT) {
      const int nr = ch / per_row, k16 = (ch % per_row) * 16;
      const int n = n0 + nr, k = s0 + k16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < N) {
        const int8_t* p = B + (long long)n * ldb + k;
        if (vec_b && k + 16 <= K) {
          v = *reinterpret_cast<const uint4*>(p);
        } else {
          for (int e = 0; e < 16 && k + e < K; ++e) set_byte(v, e, p[e]);
        }
      }
      *reinterpret_cast<uint4*>(Bs + nr * ldsb + k16) = v;
    }
    return;
  }
  // B(k, n) = B[k * ldb + n]: 4 (k) x 4 (n) byte blocks, read as four
  // 32-bit row words (neighbouring threads on neighbouring n), transposed
  // in registers, written as four 32-bit [n][k] words.
  constexpr int NQ = BN / 4;
  for (int q = tid; q < (ks / 4) * NQ; q += NT) {
    const int kq = q / NQ, nq = q % NQ;
    const int k = s0 + kq * 4, n = n0 + nq * 4;
    unsigned r[4];
    if (vec_b && n + 4 <= N && k + 4 <= K) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = *reinterpret_cast<const unsigned*>(B + (long long)(k + e) * ldb + n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = 0;
        for (int f = 0; f < 4; ++f)
          if (k + e < K && n + f < N)
            r[e] |= static_cast<unsigned>(static_cast<uint8_t>(
                        B[(long long)(k + e) * ldb + n + f])) << (8 * f);
      }
    }
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
    unsigned c[4];
    c[0] = __byte_perm(t0, t2, 0x5410);
    c[1] = __byte_perm(t0, t2, 0x7632);
    c[2] = __byte_perm(t1, t3, 0x5410);
    c[3] = __byte_perm(t1, t3, 0x7632);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<unsigned*>(Bs + (nq * 4 + f) * ldsb + kq * 4) = c[f];
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, typename ALoad,
          typename OutT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
kernel(ALoad aload, const int8_t* __restrict__ B, long long ldb, int b_trans,
       int vec_b, const int* __restrict__ D, long long ldd,
       OutT* __restrict__ C, int M, int N, int K, int shift, int act,
       int m_tiles, int n_tiles, int tiles_per_block, int weight_major,
       int ks) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int FM = WTM / 16, FN = WTN / 8;
  constexpr int LDA = BK + PAD;
  static_assert(FM >= 1 && FN >= 1 && BN % 4 == 0, "warp tile");
  const int LDB = ks + PAD;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = smem + BM * LDA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WTM, wn0 = (warp % WARPS_N) * WTN;

  int strip, mt_begin, mt_end;
  if (weight_major) {
    const int groups = (m_tiles + tiles_per_block - 1) / tiles_per_block;
    strip = blockIdx.x / groups;
    mt_begin = (blockIdx.x % groups) * tiles_per_block;
    mt_end = min(mt_begin + tiles_per_block, m_tiles);
  } else {
    mt_begin = blockIdx.x / n_tiles;
    strip = blockIdx.x % n_tiles;
    mt_end = mt_begin + 1;
  }
  const int n0 = strip * BN;
  const int kp = (K + BK - 1) / BK * BK;
  const bool resident = ks >= kp;

  for (int mt = mt_begin; mt < mt_end; ++mt) {
    const int m0 = mt * BM;
    int acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn0 + j * 8 + t * 2 + (e & 1);
          acc[i][j][e] = (D != nullptr && r < M && c < N)
                             ? D[(long long)r * ldd + c] : 0;
        }

    for (int s0 = 0; s0 < K; s0 += ks) {
      if (!resident || mt == mt_begin)
        load_b<BN, NT>(Bs, LDB, B, ldb, b_trans, vec_b, n0, s0, ks, K, N);
      const int s1 = min(s0 + ks, K);
      for (int k0 = s0; k0 < s1; k0 += BK) {
        for (int ch = tid; ch < BM * (BK / 16); ch += NT) {
          const int r = ch / (BK / 16), c16 = (ch % (BK / 16)) * 16;
          const int gr = m0 + r;
          const uint4 v = gr < M ? aload.load16(gr, k0 + c16)
                                 : make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(As + r * LDA + c16) = v;
        }
        __syncthreads();
        const int8_t* Bk = Bs + (k0 - s0);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
          unsigned af[FM][4], bf[FN][2];
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            const int8_t* p = As + (wm0 + i * 16 + g) * LDA + kk + t * 4;
            af[i][0] = *reinterpret_cast<const unsigned*>(p);
            af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDA);
            af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
            af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDA + 16);
          }
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const int8_t* p = Bk + (wn0 + j * 8 + g) * LDB + kk + t * 4;
            bf[j][0] = *reinterpret_cast<const unsigned*>(p);
            bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
          }
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], af[i], bf[j]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn0 + j * 8 + t * 2 + (e & 1);
          if (r < M && c < N)
            epi::store_int(C, (long long)r * N + c, acc[i][j][e], shift, act);
        }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, typename ALoad,
          typename OutT>
int launch_tiles(const ALoad& al, const int8_t* B, long long ldb, int b_trans,
                 int vec_b, const int* D, long long ldd, OutT* C, int M, int N,
                 int K, int shift, int act, int ws, cudaStream_t s) {
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int kp = (K + BK - 1) / BK * BK;
  const size_t a_bytes = (size_t)BM * (BK + PAD);
  int ks = BK, tiles_per_block = 1, blocks = m_tiles * n_tiles;
  if (ws) {
    int dev = 0, sms = 0, max_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    // The largest K slab of the (K, BN) weight strip that fits beside the
    // A tile: the whole strip where it can.
    const long long fit =
        ((long long)(max_smem - (int)a_bytes) / BN - PAD) / BK * BK;
    ks = (int)std::max<long long>(BK, std::min<long long>(kp, fit));
    // Enough M groups to give every SM a block; each group's M tiles share
    // one load of the strip.
    int groups = std::min(m_tiles, std::max(1, (sms + n_tiles - 1) / n_tiles));
    tiles_per_block = (m_tiles + groups - 1) / groups;
    groups = (m_tiles + tiles_per_block - 1) / tiles_per_block;
    blocks = groups * n_tiles;
  }
  const size_t smem = a_bytes + (size_t)BN * (ks + PAD);
  auto kern = kernel<BM, BN, WARPS_M, WARPS_N, ALoad, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, WARPS_M * WARPS_N * 32, smem, s>>>(
      al, B, ldb, b_trans, vec_b, D, ldd, C, M, N, K, shift, act, m_tiles,
      n_tiles, tiles_per_block, ws, ks);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the int8 GEMM: a 16-row tile for M <= 16 (the classifier
// at batch 1 computes no padded rows), 64 x 64 tiles otherwise.
template <typename ALoad, typename OutT>
int launch(const ALoad& al, const int8_t* B, long long ldb, int b_trans,
           const int* D, long long ldd, OutT* C, int M, int N, int K,
           int shift, int act, int ws, cudaStream_t s) {
  const uintptr_t pb = reinterpret_cast<uintptr_t>(B);
  const int vec_b = b_trans ? (ldb % 16 == 0 && pb % 16 == 0)
                            : (ldb % 4 == 0 && pb % 4 == 0);
  if (M <= 16)
    return launch_tiles<16, 64, 1, 4>(al, B, ldb, b_trans, vec_b, D, ldd, C,
                                      M, N, K, shift, act, ws, s);
  return launch_tiles<64, 64, 2, 2>(al, B, ldb, b_trans, vec_b, D, ldd, C, M,
                                    N, K, shift, act, ws, s);
}

}  // namespace igemm
