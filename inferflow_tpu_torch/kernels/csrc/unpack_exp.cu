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
//       its low nibble and 2r+1 in its high one; w = bf16(nibble * scale)
//       (the TPU experiment's two sub-dots, even and odd K, are one dot
//       here);
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
// X5 (unpack_dp4a): a thread owns 4 neighbouring columns (one 32-bit load
// per code row: a warp reads 128 contiguous bytes), the 4 warps of a CTA
// split its K range (64-row chunks), the CTA's activations are staged once
// in shared memory, and the K ranges of the CTAs (split-K, about two CTAs
// per SM) meet in a second small kernel that adds the partial sums in a
// fixed order.  Few bytes are in flight: a warp has one 128-byte load per
// code row outstanding.
//
// X1-X4 (unpack_mma_nibble, unpack_mma_d) are gemv_mma.cuh's
// tensor-core design: the codes become bf16 two at a time in registers,
// mma.sync m16n8k16 takes 16 columns x 16 K per instruction with the 8
// activation rows as its narrow side, and each warp streams its share of
// the CTA's 64-row blocks for all 128 columns of its tile through a ring
// in shared memory.
//   X4: int8 codes; v -> bf16(v * sc) by a float32 magic add and one bf16x2
//       pack per pair, then one bf16x2 multiply; a ring of 4 k16 steps (2
//       KB each, and a block's 256 scale bytes) filled by per-lane
//       cp.async: 3 steps (6 KB) in flight per warp, 4 warps per CTA, the
//       grid sized for two CTAs per SM (48 KB in flight per SM;
//       ift_unpack_d_inflight gives the figure for a shape).
//   X1, X2 and X3: the i4 layout's bytes, one A register per byte (byte
//       rows t and t+4 of a k16 step), so a k16 step is only 1 KB a warp:
//       a slot of the ring is two k16 steps (32 K rows, 2 KB), a warp
//       takes one 64-row block (two slots, both requested before it first
//       waits) and a CTA has 8 warps (512 rows), two CTAs an SM: 64 KB
//       requested per SM (ift_unpack_a_inflight / _b_ / _c_).  X2:
//       nibble_pair (bf16(n * sc) in 4 instructions); X1:
//       unsigned_nibble_pair (the same for u in 0..15: 0x4300 | u minus
//       128, times the scale); X3: raw_nibble_pair (exact nibbles, no
//       scale) into per-warp sums `part`, folded into the totals by one
//       fma per C register with that register's column scale when the
//       warp's share of a superblock ends (one scale row read per
//       superblock).  Each lane copies its own 16-byte chunks (cp.async,
//       piece_of's pieces where a row is not 16-byte aligned); a slot's
//       byte rows sit 160 bytes apart, so that the 8 lanes of a quarter
//       warp reading their chunks of rows t (or t+4) touch 8 distinct bank
//       groups.
// Phase timestamps on the card (globaltimer) showed what costs.  X4 at
// (4096, 4096): the activation loads, issued after the weight copies,
// waited behind them (they now go first); the warps' sums, stored 16 lanes
// to a bank, and the last CTA's split sum, one load latency per element,
// held the tail (now conflict-free and all in flight); a CTA of 8 warps,
// or a ring of 8 steps, was no faster.  X2 and X3: every CTA's first loads
// return late (the activations alone, loaded before any weight copy, took
// as long), and at 4 warps a CTA the math of a slot waited on latency (8
// warps of one block each cut X3 by a quarter); the copy engine
// (cp.async.bulk per byte row of a slot onto an mbarrier) fed the ring no
// faster than the lanes' own cp.async, and a cluster of a tile's K splits
// adding each other's sums in distributed shared memory cost more than it
// saved where 8 splits made a cluster (PERF.md).  The warps' sums meet in
// warp order, the CTAs' K splits in split order (the last CTA of each
// column tile adds them): the same bits on every run, and one launch a
// call.

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

// X4's plan (X2's and X3's too): 64-row blocks per CTA for about two CTAs
// per SM, at most kDMaxKc rows, a multiple of `unit` blocks (X3: its
// superblocks).
void plan_d(int K, int N, int sm_count, int* kc, int* ksplit, int unit = 1) {
  const int tiles = (N + 127) / 128, blocks = K / 64;
  const int want = std::max(1, (2 * sm_count + tiles - 1) / tiles);
  const int per = std::min(((blocks + want - 1) / want + unit - 1) / unit * unit,
                           kDMaxKc / 64 / unit * unit);
  *kc = per * 64;
  *ksplit = (blocks + per - 1) / per;
}

bool bad_d(int K, int N, int sm_count) {
  return K <= 0 || K % 64 || N <= 0 || N % 4 || sm_count <= 0;
}

// X1, X2 and X3 on the tensor cores, one kernel in three decode modes
// (DEC): X2 kDecSigned (nibble_pair), X1 kDecUnsigned
// (unsigned_nibble_pair), X3 kDecRaw (raw_nibble_pair, scaled after the
// dot).  grid (N / 128, ksplit), planned as X4's (plan_d); CTA y takes K rows [y * kc, y * kc +
// kc) (the last fewer), its 8 warps the 64-row blocks w, w + 8, ... of
// them for all 128 columns of tile x, each block as two slots (byte rows
// 0-15 and 16-31 of the block).  The ring's slots (kNSlot 16-byte chunks):
// byte row r's 128 bytes at chunk r * kNRowChunks, the scale row's 256 at
// kNScale.  X1 and X2 read each block's scale row (kb); X3 the scale row of the
// superblock's first block (kb rounded down to a multiple of blk / 64),
// copied only with the last block of the warp's share of a superblock,
// where its sums `part` fold into acc.
enum NibbleDecode { kDecSigned = 0, kDecUnsigned = 1, kDecRaw = 2 };
constexpr int kNWarps = 8;      // one 64-row block each at kNMaxKc rows a CTA
constexpr int kNThreads = kNWarps * 32;
constexpr int kNCtasPerSm = 2;  // __launch_bounds__: at most 128 registers
constexpr int kNMaxKc = 512;    // K rows per CTA (the B fragments' staging)
constexpr int kNRing = 2;       // slots of a warp's ring: a block's two
constexpr int kNRows = 16;      // byte rows of a slot: 32 K rows, two k16 steps
constexpr int kNRowChunks = 10; // a byte row's 128 bytes and 32 of padding
constexpr int kNScale = kNRows * kNRowChunks;  // a slot's scale row, 16 chunks
constexpr int kNSlot = kNScale + 16;
constexpr int kNSlotBytes = kNRows * 128;  // code bytes a warp streams per slot
constexpr int kNXbBytes = kNMaxKc / 16 * 32 * 8;  // the B fragments of a CTA
constexpr int kNRingBytes = kNWarps * kNRing * kNSlot * 16;
constexpr int kNSmem = kNXbBytes + kNRingBytes;
static_assert(kNRingBytes >= kNWarps * 8 * kDSumLd * (int)sizeof(float), "the sums fit the rings");

// x (8, K) bf16's rows [k0, k0 + klen) as B fragments in xb (gemv_mma.cuh's
// fragment order), 8 values (one 16-byte load) a thread; a pair of bf16 in
// memory is a fragment word.  Its loads go out before start(), the first
// copies of the weight stream, which they would otherwise queue behind.
// X4 keeps its own inline copy of this and of finish_tile: calling them
// moved its registers from 146 to 150.
template <typename Start>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x, int K, int k0,
                                        int klen, uint2* xb, Start&& start) {
  using gemv_mma::frag_word;
  constexpr int kXIters = 8 * kNMaxKc / 8 / kNThreads;
  const int nch = klen / 8;
  uint4 xv[kXIters];
#pragma unroll
  for (int it = 0; it < kXIters; ++it) {
    const int i = it * kNThreads + threadIdx.x, m = i / nch, c = 8 * (i - m * nch);
    if (i < 8 * nch) xv[it] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c));
  }
  start();
  uint32_t* xw = reinterpret_cast<uint32_t*>(xb);
#pragma unroll
  for (int it = 0; it < kXIters; ++it) {
    const int i = it * kNThreads + threadIdx.x, m = i / nch, c = 8 * (i - m * nch);
    if (i < 8 * nch) {
      xw[frag_word(m, c)] = xv[it].x, xw[frag_word(m, c + 2)] = xv[it].y;
      xw[frag_word(m, c + 4)] = xv[it].z, xw[frag_word(m, c + 6)] = xv[it].w;
    }
  }
}

// The end of X2's and X3's kernel, after its walk, as X4's: the warps'
// (8, 128) sums (each warp's C registers acc) added in warp order through
// red (shared memory, rows of kDSumLd floats), then, with more than one K
// split, the splits' sums added in split order into out (8, N) by the
// last CTA of the column tile (partial (ksplit, 8, N); a counter per tile,
// zero on entry and left zero).
__device__ __forceinline__ void finish_tile(const float (&acc)[8][4], float* red,
                                            float* __restrict__ partial,
                                            int* __restrict__ counters, float* __restrict__ out,
                                            int N, int* last_s) {
  using gemv_mma::sum_slot;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[sum_slot(warp * 8 + 2 * t + e % 2, 16 * g + 2 * q + e / 2, kDSumLd)] = acc[q][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += kNThreads) {
    const int m = i / 128, c = i % 128, cc = blockIdx.x * 128 + c;
    float v = red[sum_slot(m, c, kDSumLd)];
    for (int wp = 1; wp < kNWarps; ++wp) v = __fadd_rn(v, red[sum_slot(wp * 8 + m, c, kDSumLd)]);
    if (gridDim.y == 1) {
      if (cc < N) out[(size_t)m * N + cc] = v;
    } else if (cc < N) {
      partial[((size_t)blockIdx.y * 8 + m) * N + cc] = v;
    }
  }
  if (gridDim.y == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_s = atomicAdd(&counters[blockIdx.x], 1) == gridDim.y - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // every element of the thread, four splits at a time, all their loads
  // in flight at once; each element's splits added in split order
  constexpr int kE = 8 * 128 / kNThreads;
  const int ks = gridDim.y;
  const size_t stride = (size_t)8 * N;
  float sum[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) sum[e] = 0.f;
  for (int z0 = 0; z0 < ks; z0 += 4) {
    float f[kE][4];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = threadIdx.x + e * kNThreads, cc = blockIdx.x * 128 + i % 128;
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
    const int i = threadIdx.x + e * kNThreads, cc = blockIdx.x * 128 + i % 128;
    if (cc < N) out[(size_t)(i / 128) * N + cc] = sum[e];
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <int DEC>
__global__ void __launch_bounds__(kNThreads, kNCtasPerSm)
unpack_mma_nibble(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                  const __nv_bfloat16* __restrict__ scale, float* __restrict__ partial,
                  int* __restrict__ counters, float* __restrict__ out, int K, int N, int kc,
                  int blk) {
  using namespace gemv_mma;
  constexpr bool RAW = DEC == kDecRaw;
  extern __shared__ uint4 smem_nib[];
  uint2* xb = reinterpret_cast<uint2*>(smem_nib);  // B fragments of the CTA's K slice
  // the warps' rings; after the walk, their sums [warp * 8 + row][kDSumLd]
  uint4* rings = smem_nib + kNXbBytes / 16;
  __shared__ int last_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.y * kc, klen = min(kc, K - k0);
  const int col = blockIdx.x * 128 + 16 * g;  // the lane's 16 columns
  uint4* ring = rings + warp * kNRing * kNSlot;

  const int nblk = klen / 64;
  const int slots = warp < nblk ? ((nblk - 1 - warp) / kNWarps + 1) * 2 : 0;
  const int cvalid = min(max(N - col, 0), 16);  // bytes of the lane's code chunks
  const int cpiece = piece_of(codes, N, col);
  const int scol = col + 8 * t;  // lanes t < 2 copy scale chunk t of the group
  const int svalid = 2 * min(max(N - scol, 0), 8);
  const int spiece = piece_of(scale, 2LL * N, 2LL * scol);
  // X3: the warp's share of block lb's superblock ends with lb
  auto folds = [&](int lb) {
    const int kb = k0 / 64 + lb, per = blk / 64;
    return lb + kNWarps >= nblk || (kb + kNWarps) / per != kb / per;
  };
  // slot u: byte rows 16 (u % 2) .. + 15 of the warp's block u / 2, and at
  // a block's first slot the scale row it reads
  auto issue = [&](int u) {
    if (u < slots) {
      uint4* s = ring + (u % kNRing) * kNSlot;
      const int lb = warp + (u / 2) * kNWarps, kb = k0 / 64 + lb;
      const size_t row0 = (size_t)kb * 32 + (u % 2) * kNRows;
      const bool with_scale = u % 2 == 0 && (!RAW || folds(lb));
      const int srow = RAW ? kb - kb % (blk / 64) : kb;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // rows t, t + 4 of each k16 step
        const int r = t + 4 * q;
        cp_async_chunk(&s[r * kNRowChunks + g], cvalid ? codes + (row0 + r) * N + col : codes,
                       cvalid, cpiece);
      }
      if (with_scale && t < 2)
        cp_async_chunk(&s[kNScale + 2 * g + t], svalid ? scale + (size_t)srow * N + scol : scale,
                       svalid, spiece);
    }
    cp_async_commit();
  };
  stage_x(x, K, k0, klen, xb, [&] {
#pragma unroll
    for (int u = 0; u < kNRing - 1; ++u) issue(u);
  });
  __syncthreads();

  float acc[8][4], part[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f, part[q][e] = 0.f;
  uint32_t sw[8];     // the scale row's bf16 pairs of the lane's 16 columns
  uint32_t sc2[16];   // X1, X2: the block's bf16 scale of each column, in both halves
  for (int u = 0; u < slots; ++u) {
    __syncwarp();  // every lane has read the slot refilled next
    issue(u + kNRing - 1);
    cp_async_wait<kNRing - 1>();
    __syncwarp();  // the group's scale chunks came from lanes t < 2
    const uint4* s = ring + (u % kNRing) * kNSlot;
    const int lb = warp + (u / 2) * kNWarps, h = u % 2;
    if (h == 0 && (!RAW || folds(lb))) {
      const uint4 s0 = s[kNScale + 2 * g], s1 = s[kNScale + 2 * g + 1];
      sw[0] = s0.x, sw[1] = s0.y, sw[2] = s0.z, sw[3] = s0.w;
      sw[4] = s1.x, sw[5] = s1.y, sw[6] = s1.z, sw[7] = s1.w;
      if constexpr (!RAW) {
#pragma unroll
        for (int c = 0; c < 16; ++c) sc2[c] = __byte_perm(sw[c / 2], 0u, c % 2 ? 0x3232u : 0x1010u);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // byte rows t and t + 4 of k16 step j: K rows 2t, 2t+1 (a0, a1) and
      // 2t+8, 2t+9 (a2, a3)
      const uint4 lo = s[(8 * j + t) * kNRowChunks + g];
      const uint4 hi = s[(8 * j + t + 4) * kNRowChunks + g];
      const uint2 b = xb[(lb * 4 + 2 * h + j) * 32 + lane];
      const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint32_t l = wl[v], l4 = l >> 4, r = wh[v], r4 = r >> 4;
        if constexpr (RAW) {
          mma(part[2 * v], raw_nibble_pair<0>(l, l4), raw_nibble_pair<1>(l, l4),
              raw_nibble_pair<0>(r, r4), raw_nibble_pair<1>(r, r4), b);
          mma(part[2 * v + 1], raw_nibble_pair<2>(l, l4), raw_nibble_pair<3>(l, l4),
              raw_nibble_pair<2>(r, r4), raw_nibble_pair<3>(r, r4), b);
        } else if constexpr (DEC == kDecUnsigned) {
          mma(acc[2 * v], unsigned_nibble_pair<0>(l, l4, sc2[4 * v]),
              unsigned_nibble_pair<1>(l, l4, sc2[4 * v + 1]),
              unsigned_nibble_pair<0>(r, r4, sc2[4 * v]),
              unsigned_nibble_pair<1>(r, r4, sc2[4 * v + 1]), b);
          mma(acc[2 * v + 1], unsigned_nibble_pair<2>(l, l4, sc2[4 * v + 2]),
              unsigned_nibble_pair<3>(l, l4, sc2[4 * v + 3]),
              unsigned_nibble_pair<2>(r, r4, sc2[4 * v + 2]),
              unsigned_nibble_pair<3>(r, r4, sc2[4 * v + 3]), b);
        } else {
          mma(acc[2 * v], nibble_pair<0>(l, l4, sc2[4 * v]), nibble_pair<1>(l, l4, sc2[4 * v + 1]),
              nibble_pair<0>(r, r4, sc2[4 * v]), nibble_pair<1>(r, r4, sc2[4 * v + 1]), b);
          mma(acc[2 * v + 1], nibble_pair<2>(l, l4, sc2[4 * v + 2]),
              nibble_pair<3>(l, l4, sc2[4 * v + 3]), nibble_pair<2>(r, r4, sc2[4 * v + 2]),
              nibble_pair<3>(r, r4, sc2[4 * v + 3]), b);
        }
      }
    }
    if constexpr (RAW) {
      if (h == 1 && folds(lb)) {
        // C register e of n-tile q is column 2q + e / 2 of the lane's 16
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * q + e / 2;
            const uint32_t bits = c % 2 ? sw[c / 2] & 0xFFFF0000u : sw[c / 2] << 16;
            acc[q][e] = fmaf(part[q][e], __uint_as_float(bits), acc[q][e]);
            part[q][e] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  finish_tile(acc, reinterpret_cast<float*>(rings), partial, counters, out, N, &last_s);
}

// X1's, X2's and X3's plan: X4's, in whole superblocks for X3.  False for a
// shape the kernel refuses (K a multiple of 64 and N of 4; X3: blk a
// multiple of 128 up to 512 that divides K).
bool plan_nibble(int K, int N, int blk, int sm_count, int* kc, int* ksplit) {
  if (bad_d(K, N, sm_count) || blk < 0 || blk % 128 || blk > kNMaxKc || (blk && K % blk))
    return false;
  plan_d(K, N, sm_count, kc, ksplit, blk ? blk / 64 : 1);
  return true;
}

// the kernel's dynamic shared memory (above the 48 KB a kernel gets
// without asking), with the SM's memory preferred as shared memory
template <int DEC>
cudaError_t nibble_ready() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(unpack_mma_nibble<DEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kNSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(unpack_mma_nibble<DEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <int DEC>
int run_nibble(const void* x, const void* codes, const void* scale, void* partial,
               void* counters, void* out, int K, int N, int blk, int sm_count, void* stream) {
  int kc = 0, ksplit = 0;
  if ((DEC == kDecRaw) != (blk > 0) || !plan_nibble(K, N, blk, sm_count, &kc, &ksplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = nibble_ready<DEC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_mma_nibble<DEC><<<dim3((N + 127) / 128, ksplit), kNThreads, kNSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<float*>(out), K, N, kc, blk);
  return static_cast<int>(cudaGetLastError());
}

// The code bytes X1, X2 or X3 keeps in flight per SM at (K, N): the CTAs an SM
// holds at once (the runtime's occupancy, at most the grid's share) x the
// warps with a block (one block each) x its two slots, all requested
// before the warp's first wait; -1 for a shape it refuses.
template <int DEC>
int nibble_inflight(int K, int N, int blk, int sm_count) {
  int kc = 0, ksplit = 0, resident = 0;
  if ((DEC == kDecRaw) != (blk > 0) || !plan_nibble(K, N, blk, sm_count, &kc, &ksplit) ||
      nibble_ready<DEC>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, unpack_mma_nibble<DEC>, kNThreads,
                                                    kNSmem) != cudaSuccess)
    return -1;
  const int grid = (N + 127) / 128 * ksplit;
  resident = std::min(resident, (grid + sm_count - 1) / sm_count);
  return resident * std::min(kNWarps, kc / 64) * kNRing * kNSlotBytes;
}

int registers_of(const void* kernel) {
  cudaFuncAttributes attr{};
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : -1;
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

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X2: x (8, K) bf16, codes4 (K/2, N) uint8 (signed nibbles), scale (K/64,
// N) bf16 -> out (8, N) float (K a multiple of 64, N of 4).  X1: the same
// on packed (K/2, N) unsigned nibbles.  X3: the same on packed (K/2, N)
// raw nibbles, superblocks of blk values (a multiple of 128 up to 512 that
// divides K).  `partial` holds ift_unpack_b_splits(K, N, sm_count)
// (ift_unpack_a_splits, ift_unpack_c_splits(K, N, blk, sm_count)) * 8 * N
// floats, `counters` ceil(N / 128) int32, zero on entry and left zero.
int ift_unpack_a_splits(int K, int N, int sm_count) {
  int kc = 0, ksplit = 0;
  return plan_nibble(K, N, 0, sm_count, &kc, &ksplit) ? ksplit : -1;
}
int ift_unpack_b_splits(int K, int N, int sm_count) {
  int kc = 0, ksplit = 0;
  return plan_nibble(K, N, 0, sm_count, &kc, &ksplit) ? ksplit : -1;
}
int ift_unpack_c_splits(int K, int N, int blk, int sm_count) {
  int kc = 0, ksplit = 0;
  return blk > 0 && plan_nibble(K, N, blk, sm_count, &kc, &ksplit) ? ksplit : -1;
}
int ift_unpack_a(const void* x, const void* packed, const void* scale, void* partial,
                 void* counters, void* out, int K, int N, int sm_count, void* stream) {
  return run_nibble<kDecUnsigned>(x, packed, scale, partial, counters, out, K, N, 0, sm_count,
                                  stream);
}
int ift_unpack_b(const void* x, const void* codes4, const void* scale, void* partial,
                 void* counters, void* out, int K, int N, int sm_count, void* stream) {
  return run_nibble<kDecSigned>(x, codes4, scale, partial, counters, out, K, N, 0, sm_count,
                                stream);
}
int ift_unpack_c(const void* x, const void* packed, const void* scale, void* partial,
                 void* counters, void* out, int K, int N, int blk, int sm_count, void* stream) {
  return run_nibble<kDecRaw>(x, packed, scale, partial, counters, out, K, N, blk, sm_count,
                             stream);
}
int ift_unpack_a_inflight(int K, int N, int sm_count) {
  return nibble_inflight<kDecUnsigned>(K, N, 0, sm_count);
}
int ift_unpack_b_inflight(int K, int N, int sm_count) {
  return nibble_inflight<kDecSigned>(K, N, 0, sm_count);
}
int ift_unpack_c_inflight(int K, int N, int blk, int sm_count) {
  return nibble_inflight<kDecRaw>(K, N, blk, sm_count);
}
// The registers a thread of X`which`'s kernel takes ('a' .. 'e'; X5
// without its reduce kernel); -1 for another letter.
int ift_unpack_registers(int which) {
  switch (which) {
    case 'a': return registers_of(reinterpret_cast<const void*>(unpack_mma_nibble<kDecUnsigned>));
    case 'b': return registers_of(reinterpret_cast<const void*>(unpack_mma_nibble<kDecSigned>));
    case 'c': return registers_of(reinterpret_cast<const void*>(unpack_mma_nibble<kDecRaw>));
    case 'd': return registers_of(reinterpret_cast<const void*>(unpack_mma_d));
    case 'e': return registers_of(reinterpret_cast<const void*>(unpack_dp4a));
    default: return -1;
  }
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
