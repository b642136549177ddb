// The unpack experiments X1-X5: five ways to turn stored weight codes into
// the products of an 8-row GEMV (X5: 32 rows), for measuring which one lets
// a decode GEMV approach its byte bound.
//
// Replaces tools/exp_unpack.py's Pallas kernels run_a (:59, its
// pallas_call at :73), run_b (:90, :97), run_c (:113, :134), run_d (:151,
// :158) and run_e (:174, :183).  Each computes what its run_* computes, in
// the same types (x (8, K) bf16; scale (K/64, N) bf16, one row per 64 K
// values; out (8, N) float32):
//   X1 (unpack_a): packed (K/2, N) uint8, byte row r holding K row 2r in
//       its low nibble and 2r+1 in its high one; w = bf16(nibble * scale),
//       both nibbles shifted, masked and converted, two FMA sub-dots;
//   X2 (unpack_b): int4 codes in -8..7, stored two per byte in the same
//       order (torch has no int4 type); w = bf16(float(code) * scale);
//   X3 (unpack_c): X1's nibbles dotted raw (unscaled) over each `blk`-value
//       superblock, the partial sum multiplied after by the scale of the
//       superblock's FIRST 64-row block only (the TPU experiment's speed
//       shape, not exact dequantization; the plain version does the same);
//   X4 (unpack_d): int8 codes (K, N); w = bf16(float(code) * scale);
//   X5 (unpack_e): xq (32, K) int8 times int8 codes (K, N) with int32
//       accumulation (dp4a), then float(acc) * colscale (1, N) bf16.
//
// What bounds it on the H100: each is a GEMV over (K, N) codes with 8 (X5:
// 32) activation rows, far below the card's operations per byte: the code
// and scale bytes.
//
// X1-X3 and X5 (unpack_gemv, unpack_dp4a): a thread owns 4 neighbouring
// columns (one 32-bit load per code row: a warp reads 128 contiguous
// bytes), the 4 warps of a CTA split its K range (64-row chunks; X3 a
// superblock in quarters), the CTA's activations are staged once in shared
// memory, and the K ranges of the CTAs (split-K, about two CTAs per SM)
// meet in a second small kernel that adds the partial sums in a fixed
// order.  The strategies differ only in the per-code work between the load
// and the FMA (or dp4a), which is what the experiment measures.  Few bytes
// are in flight: a warp has one 128-byte load per code row outstanding.
//
// X4 (unpack_mma_d) is gemv_mma.cuh's tensor-core design: the int8 codes
// become bf16(v * sc) two at a time in registers (a float32 magic add and
// one bf16x2 pack per pair, then one bf16x2 multiply), mma.sync m16n8k16
// takes 16 columns x 16 K per instruction with the 8 activation rows as
// its narrow side, and each warp streams its 64-row blocks (4 k16 steps of
// 128 columns, 2 KB each, and the block's 256 scale bytes) through a
// 4-step cp.async ring in shared memory: 3 steps (6 KB) in flight per
// warp, 4 warps per CTA, the grid sized for two CTAs per SM (48 KB in
// flight per SM; ift_unpack_d_inflight gives the figure for a shape).
// Phase timestamps on the card (globaltimer, (4096, 4096)) showed what
// costs: the activation loads, issued after the weight copies, waited
// behind them (they now go first); the warps' sums, stored 16 lanes to a
// bank, and the last CTA's split sum, one load latency per element, held
// the tail (now conflict-free and all in flight).  A CTA of 8 warps, or a
// ring of 8 steps, was no faster.  The warps' sums meet in warp order,
// the CTAs' K splits in split order (the last CTA of each column tile adds
// them): the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemv_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;  // 32 lanes x 4 columns
constexpr int kMaxKc = 512;  // K values per CTA (activation staging)

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// The kind of code and its per-weight work.
enum Mode { kNibble = 0, kSignedNibble = 1, kRawNibble = 2 };

// X1-X3: grid (N / kCols, K / kc); out partial (ksplit, 8, N) float.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
unpack_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scale, float* __restrict__ partial,
            int K, int N, int kc, int blk) {
  constexpr int M = 8;
  __shared__ float xs[M][kMaxKc];
  __shared__ float red[kWarps][M][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int k_begin = blockIdx.y * kc;
  for (int i = threadIdx.x; i < M * kc; i += kThreads) {
    const int m = i / kc, kk = i - m * kc;
    xs[m][kk] = bf(x[(size_t)m * K + k_begin + kk]);
  }
  __syncthreads();

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // a warp's chunks: 64 K values each (X3: a quarter of a superblock)
  const int chunk = MODE == kRawNibble ? blk / kWarps : 64;
  if (col0 < N) {
    for (int c0 = warp * chunk; c0 < kc; c0 += kWarps * chunk) {
      const int k0 = k_begin + c0;
      float sc[4], part[M][4];
      if (MODE == kRawNibble) {
        // the scale of the superblock's first 64-row block
        const int srow = (k0 / blk) * (blk / 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[j] = bf(scale[(size_t)srow * N + col0 + j]);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
      }
      for (int r = 0; r < chunk / 2; ++r) {  // byte rows: K rows 2r, 2r+1
        const int k = 2 * r;
        if (MODE != kRawNibble && k % 64 == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sc[j] = bf(scale[(size_t)((k0 + k) / 64) * N + col0 + j]);
        }
        const uint32_t w4 = __ldg(reinterpret_cast<const uint32_t*>(
            codes + (size_t)((k0 + k) / 2) * N + col0));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b = (w4 >> (8 * j)) & 0xFFu;
          float lo, hi;
          if (MODE == kSignedNibble) {
            lo = float(int((b & 0xFu) ^ 8u) - 8);
            hi = float(int((b >> 4) ^ 8u) - 8);
          } else {
            lo = float(b & 0xFu);
            hi = float(b >> 4);
          }
          if (MODE == kRawNibble) {
#pragma unroll
            for (int m = 0; m < M; ++m) {
              part[m][j] = fmaf(xs[m][c0 + k], lo, part[m][j]);
              part[m][j] = fmaf(xs[m][c0 + k + 1], hi, part[m][j]);
            }
          } else {
            const float wl = round_bf16(lo * sc[j]), wh = round_bf16(hi * sc[j]);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              acc[m][j] = fmaf(xs[m][c0 + k], wl, acc[m][j]);
              acc[m][j] = fmaf(xs[m][c0 + k + 1], wh, acc[m][j]);
            }
          }
        }
      }
      if (MODE == kRawNibble) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(part[m][j], sc[j], acc[m][j]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kCols; i += kThreads) {
    const int m = i / kCols, c = i - m * kCols;
    const int col = blockIdx.x * kCols + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    partial[((size_t)blockIdx.y * M + m) * N + col] = s;
  }
}

// X5: grid (N / kCols, K / kc); xq (32, K) int8, codes (K, N) int8; out
// partial (ksplit, 32, N) int32.  Four code rows of 4 columns are loaded as
// four words and transposed (byte permutes) into one word per column, the
// 4 K values dp4a takes.
__global__ void __launch_bounds__(kThreads)
unpack_dp4a(const int8_t* __restrict__ xq, const int8_t* __restrict__ codes,
            int* __restrict__ partial, int K, int N, int kc) {
  constexpr int M = 32;
  __shared__ int xs[M][kMaxKc / 4];
  __shared__ int red[kWarps][M][kCols / 4];  // reused per 4-column slice
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int k_begin = blockIdx.y * kc;
  const int kw = kc / 4;
  for (int i = threadIdx.x; i < M * kw; i += kThreads) {
    const int m = i / kw, w = i - m * kw;
    xs[m][w] = *reinterpret_cast<const int*>(xq + (size_t)m * K + k_begin + 4 * w);
  }
  __syncthreads();

  int acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  if (col0 < N) {
    for (int c0 = warp * 64; c0 < kc; c0 += kWarps * 64) {
      for (int k = 0; k < 64; k += 4) {
        const int8_t* p = codes + (size_t)(k_begin + c0 + k) * N + col0;
        const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
        const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(p + N));
        const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * (size_t)N));
        const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * (size_t)N));
        // column j's 4 K values: byte j of r0..r3
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
        const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
        const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
        int cw[4];
        cw[0] = int(__byte_perm(lo01, lo23, 0x5410));
        cw[1] = int(__byte_perm(lo01, lo23, 0x7632));
        cw[2] = int(__byte_perm(hi01, hi23, 0x5410));
        cw[3] = int(__byte_perm(hi01, hi23, 0x7632));
        const int xw = (c0 + k) / 4;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int xv = xs[m][xw];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xv, cw[j], acc[m][j]);
        }
      }
    }
  }

  // the warps' sums, one column of the 4 at a time (shared memory for a
  // quarter of the tile)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp][m][lane] = acc[m][j];
    __syncthreads();
    for (int i = threadIdx.x; i < M * 32; i += kThreads) {
      const int m = i / 32, l = i % 32;
      const int col = blockIdx.x * kCols + l * 4 + j;
      if (col < N) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][m][l];
        partial[((size_t)blockIdx.y * M + m) * N + col] = s;
      }
    }
    __syncthreads();
  }
}

// X4 on the tensor cores (gemv_mma.cuh).  grid (N / 128, ksplit); CTA y
// takes K rows [y * kc, y * kc + kc) (the last fewer), its 4 warps the
// 64-row blocks w, w + 4, ... of them for all 128 columns of tile x.  Each
// CTA leaves its (8, 128) sums in partial (ksplit, 8, N); the last CTA of
// a tile (a counter per tile, zero on entry and left zero) adds the splits
// in split order into out (8, N).
constexpr int kDWarps = 4;
constexpr int kDThreads = kDWarps * 32;
constexpr int kDRing = 4;        // k16 steps of a warp's ring: a whole block
constexpr int kDMaxKc = 512;     // K values per CTA (the B fragments' staging)
constexpr int kDSlot = 4 * 32 + 2 * 8;  // chunks a step: 4 code rows a lane, 2 scale chunks a group
constexpr int kDStepBytes = 4 * 32 * 16;  // code bytes a warp streams per k16 step
constexpr int kDSumLd = 132;  // floats a row of the warps' sums (sum_slot)

__global__ void __launch_bounds__(kDThreads)
unpack_mma_d(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
             const __nv_bfloat16* __restrict__ scale, float* __restrict__ partial,
             int* __restrict__ counters, float* __restrict__ out, int K, int N, int kc) {
  using namespace gemv_mma;
  // the warps' rings; after the walk, their sums [warp * 8 + row][kDSumLd]
  __shared__ uint4 ring_s[kDWarps * kDRing * kDSlot];
  __shared__ uint2 xb[kDMaxKc / 16][32];  // B fragments of the CTA's K slice
  __shared__ int last_s;
  static_assert(sizeof(ring_s) >= kDWarps * 8 * kDSumLd * sizeof(float), "the sums fit the rings");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.y * kc, klen = min(kc, K - k0);
  const int col = blockIdx.x * 128 + 16 * g;  // the lane's 16 columns
  uint4* ring = ring_s + warp * kDRing * kDSlot;

  const int nblk = klen / 64;
  const int steps = warp < nblk ? ((nblk - 1 - warp) / kDWarps + 1) * 4 : 0;
  const int cvalid = min(max(N - col, 0), 16);  // bytes of the lane's code chunks
  const int cpiece = piece_of(codes, N, col);
  const int scol = col + 8 * t;  // lanes t < 2 copy scale chunk t of the group
  const int svalid = 2 * min(max(N - scol, 0), 8);
  const int spiece = piece_of(scale, 2LL * N, 2LL * scol);
  auto issue = [&](int u) {
    if (u < steps) {
      uint4* s = ring + (u % kDRing) * kDSlot;
      const int j = u % 4, kb = k0 / 64 + warp + (u / 4) * kDWarps;
      const int r0 = kb * 64 + j * 16 + 2 * t;
      const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async_chunk(&s[q * 32 + lane], cvalid ? codes + (size_t)rows[q] * N + col : codes,
                       cvalid, cpiece);
      if (j == 0 && t < 2)
        cp_async_chunk(&s[128 + t * 8 + g], svalid ? scale + (size_t)kb * N + scol : scale,
                       svalid, spiece);
    }
    cp_async_commit();
  };
  // x as B fragments, 8 values (one 16-byte load) a thread; a pair of
  // bf16 in memory is a fragment word.  Its loads go out before the
  // weight stream's, which they would otherwise queue behind
  constexpr int kXIters = 8 * kDMaxKc / 8 / kDThreads;
  const int nch = klen / 8;
  uint4 xv[kXIters];
#pragma unroll
  for (int it = 0; it < kXIters; ++it) {
    const int i = it * kDThreads + threadIdx.x, m = i / nch, c = 8 * (i - m * nch);
    if (i < 8 * nch) xv[it] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c));
  }
#pragma unroll
  for (int u = 0; u < kDRing - 1; ++u) issue(u);
  uint32_t* xw = reinterpret_cast<uint32_t*>(&xb[0][0]);
#pragma unroll
  for (int it = 0; it < kXIters; ++it) {
    const int i = it * kDThreads + threadIdx.x, m = i / nch, c = 8 * (i - m * nch);
    if (i < 8 * nch) {
      xw[frag_word(m, c)] = xv[it].x, xw[frag_word(m, c + 2)] = xv[it].y;
      xw[frag_word(m, c + 4)] = xv[it].z, xw[frag_word(m, c + 6)] = xv[it].w;
    }
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  uint32_t sc2[16];  // the block's bf16 scale of each column, in both halves
  for (int u = 0; u < steps; ++u) {
    __syncwarp();  // every lane has read the slot refilled next
    issue(u + kDRing - 1);
    cp_async_wait<kDRing - 1>();
    __syncwarp();  // the group's scale chunks came from lanes t < 2
    const uint4* s = ring + (u % kDRing) * kDSlot;
    const int j = u % 4;
    if (j == 0) {
      const uint4 s0 = s[128 + g], s1 = s[128 + 8 + g];
      const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) sc2[c] = __byte_perm(sw[c / 2], 0u, c % 2 ? 0x3232u : 0x1010u);
    }
    const uint4 r[4] = {s[lane], s[32 + lane], s[64 + lane], s[96 + lane]};
    const uint2 b = xb[(warp + (u / 4) * kDWarps) * 4 + j][lane];
    const uint32_t w[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                              {r[0].y, r[1].y, r[2].y, r[3].y},
                              {r[0].z, r[1].z, r[2].z, r[3].z},
                              {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      // rows 2t, 2t+1 (a0, a1) and 2t+8, 2t+9 (a2, a3) of columns 4v..4v+3
      const uint32_t r0 = w[v][0] ^ 0x80808080u, r1 = w[v][1] ^ 0x80808080u;
      const uint32_t r2 = w[v][2] ^ 0x80808080u, r3 = w[v][3] ^ 0x80808080u;
      mma(acc[2 * v], int8_pair<0>(r0, r1, sc2[4 * v]), int8_pair<1>(r0, r1, sc2[4 * v + 1]),
          int8_pair<0>(r2, r3, sc2[4 * v]), int8_pair<1>(r2, r3, sc2[4 * v + 1]), b);
      mma(acc[2 * v + 1], int8_pair<2>(r0, r1, sc2[4 * v + 2]),
          int8_pair<3>(r0, r1, sc2[4 * v + 3]), int8_pair<2>(r2, r3, sc2[4 * v + 2]),
          int8_pair<3>(r2, r3, sc2[4 * v + 3]), b);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums in warp order, then the splits' in split order
  float* red = reinterpret_cast<float*>(ring_s);  // [warp * 8 + row][kDSumLd]
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[sum_slot(warp * 8 + 2 * t + e % 2, 16 * g + 2 * q + e / 2, kDSumLd)] = acc[q][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += kDThreads) {
    const int m = i / 128, c = i % 128, cc = blockIdx.x * 128 + c;
    float v = red[sum_slot(m, c, kDSumLd)];
    for (int wp = 1; wp < kDWarps; ++wp) v = __fadd_rn(v, red[sum_slot(wp * 8 + m, c, kDSumLd)]);
    if (gridDim.y == 1) {
      if (cc < N) out[(size_t)m * N + cc] = v;
    } else if (cc < N) {
      partial[((size_t)blockIdx.y * 8 + m) * N + cc] = v;
    }
  }
  if (gridDim.y == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(&counters[blockIdx.x], 1) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every element of the thread, four splits at a time, all their loads
  // in flight at once; each element's splits added in split order
  constexpr int kE = 8 * 128 / kDThreads;
  const int ks = gridDim.y;
  const size_t stride = (size_t)8 * N;
  float sum[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) sum[e] = 0.f;
  for (int z0 = 0; z0 < ks; z0 += 4) {
    float f[kE][4];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = threadIdx.x + e * kDThreads, cc = blockIdx.x * 128 + i % 128;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        f[e][d] = cc < N && z0 + d < ks
                      ? __ldcg(partial + (z0 + d) * stride + (size_t)(i / 128) * N + cc)
                      : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (z0 + d < ks) sum[e] = __fadd_rn(sum[e], f[e][d]);
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = threadIdx.x + e * kDThreads, cc = blockIdx.x * 128 + i % 128;
    if (cc < N) out[(size_t)(i / 128) * N + cc] = sum[e];
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// X4's plan: 64-row blocks per CTA for about two CTAs per SM, at most
// kDMaxKc rows.
void plan_d(int K, int N, int sm_count, int* kc, int* ksplit) {
  const int tiles = (N + 127) / 128, blocks = K / 64;
  const int want = std::max(1, (2 * sm_count + tiles - 1) / tiles);
  const int per = std::min(std::max((blocks + want - 1) / want, 1), kDMaxKc / 64);
  *kc = per * 64;
  *ksplit = (blocks + per - 1) / per;
}

bool bad_d(int K, int N, int sm_count) {
  return K <= 0 || K % 64 || N <= 0 || N % 4 || sm_count <= 0;
}

__global__ void reduce_float(const float* __restrict__ partial, float* __restrict__ out,
                             int mn, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * mn + i];
  out[i] = s;
}

__global__ void reduce_int_scale(const int* __restrict__ partial,
                                 const __nv_bfloat16* __restrict__ colscale,
                                 float* __restrict__ out, int M, int N, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  int s = 0;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * M * N + i];
  out[i] = float(s) * bf(colscale[i % N]);
}

bool bad_shape(int K, int N, int kc, int unit) {
  return K <= 0 || N <= 0 || N % 4 || kc <= 0 || kc > kMaxKc || kc % unit ||
         K % kc;
}

template <int MODE>
int run_unpack(const void* x, const void* codes, const void* scale, void* partial,
               void* out, int K, int N, int kc, int blk, void* stream_ptr) {
  const int unit = MODE == kRawNibble ? blk : 64;
  if (bad_shape(K, N, kc, unit) ||
      (MODE == kRawNibble && (blk < 128 || blk % 128 || blk > kMaxKc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ksplit = K / kc;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  unpack_gemv<MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(partial), K, N,
      kc, blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = 8 * N;
  reduce_float<<<(mn + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), mn, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X1-X3: x (8, K) bf16, codes (K/2, N) uint8, scale (K/64, N) bf16 ->
// out (8, N) float; `partial` holds (K/kc, 8, N) floats; each CTA takes kc
// K values (a multiple of 64, X3: of blk, at most 512).
int ift_unpack_a(const void* x, const void* packed, const void* scale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  return run_unpack<kNibble>(x, packed, scale, partial, out, K, N, kc, 64, stream);
}
int ift_unpack_b(const void* x, const void* codes4, const void* scale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  return run_unpack<kSignedNibble>(x, codes4, scale, partial, out, K, N, kc, 64, stream);
}
int ift_unpack_c(const void* x, const void* packed, const void* scale, void* partial,
                 void* out, int K, int N, int kc, int blk, void* stream) {
  return run_unpack<kRawNibble>(x, packed, scale, partial, out, K, N, kc, blk, stream);
}
// X4: x (8, K) bf16, codes8 (K, N) int8, scale (K/64, N) bf16 -> out (8,
// N) float (K a multiple of 64, N of 4); `partial` holds
// ift_unpack_d_splits(K, N, sm_count) * 8 * N floats, `counters` ceil(N /
// 128) int32, zero on entry and left zero.
int ift_unpack_d_splits(int K, int N, int sm_count) {
  if (bad_d(K, N, sm_count)) return -1;
  int kc = 0, ksplit = 0;
  plan_d(K, N, sm_count, &kc, &ksplit);
  return ksplit;
}
int ift_unpack_d(const void* x, const void* codes8, const void* scale, void* partial,
                 void* counters, void* out, int K, int N, int sm_count, void* stream) {
  if (bad_d(K, N, sm_count)) return static_cast<int>(cudaErrorInvalidValue);
  int kc = 0, ksplit = 0;
  plan_d(K, N, sm_count, &kc, &ksplit);
  unpack_mma_d<<<dim3((N + 127) / 128, ksplit), kDThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes8),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<float*>(out), K, N, kc);
  return static_cast<int>(cudaGetLastError());
}
// The code bytes X4 keeps in flight per SM at (K, N): the CTAs an SM holds
// at once (the runtime's occupancy, at most the grid's share) x 4 warps x
// the 3 k16 steps a warp's ring holds ahead; -1 for a shape it refuses.
int ift_unpack_d_inflight(int K, int N, int sm_count) {
  if (bad_d(K, N, sm_count)) return -1;
  int kc = 0, ksplit = 0, resident = 0;
  plan_d(K, N, sm_count, &kc, &ksplit);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, unpack_mma_d, kDThreads, 0) !=
      cudaSuccess)
    return -1;
  const int grid = (N + 127) / 128 * ksplit;
  resident = std::min(resident, (grid + sm_count - 1) / sm_count);
  return resident * kDWarps * (kDRing - 1) * kDStepBytes;
}

// X5: xq (32, K) int8, codes (K, N) int8, colscale (1, N) bf16 -> out
// (32, N) float; `partial` holds (K/kc, 32, N) int32.
int ift_unpack_e(const void* xq, const void* codes8, const void* colscale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  if (bad_shape(K, N, kc, 64) || K % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksplit = K / kc;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  unpack_dp4a<<<grid, kThreads, 0, st>>>(static_cast<const int8_t*>(xq),
                                         static_cast<const int8_t*>(codes8),
                                         static_cast<int*>(partial), K, N, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = 32 * N;
  reduce_int_scale<<<(mn + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(partial), static_cast<const __nv_bfloat16*>(colscale),
      static_cast<float*>(out), 32, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
