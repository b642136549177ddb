// Attention over the stacked KV cache: single-token decode (B2) and the
// chunked-prefill flash attention of one slot's query chunk (B3); and
// single-token decode over the paged pool (B7, below the first two).
//
// Replaces inferflow_tpu/kernels/attention.py `_make_kernel` (pallas_call at
// :259, public entry `decode_attention` at :473) and `_make_chunk_kernel`
// (pallas_call at :681, public entry `chunk_attention` at :706).
//
// Cache layout (the logical one; no sequence packing):
//   k, v        (L, B, H, S, D) int8 codes, or bf16 for an unquantized cache
//   k/v scales  (L, B, H, S, D/blk) f16, one per blk-element block of a row
// The layer index is an argument: the kernels read the whole stacked cache
// in place, no per-layer copy.  Each key/value element is dequantized on
// read as code*scale in float32 (exact: an 8-bit code times an f16 scale).
//
// What bounds it on the H100: decode reads every live cache row of every
// (slot, kv head) once and does ~4*D flops per row per query row, far below
// the card's flops per byte: it is bound by the int8 cache bytes (plus the
// f16 scales).  Chunked prefill reuses each cached row for C*g query rows,
// which moves it toward the operation bound.
//
// What the design does about it:
//   - one CTA per (slot, kv head) for decode serves that head's g query
//     rows (GQA) from one read of the K/V rows; each slot's walk is split
//     by length into up to `nsplit` CTAs of whole tiles (at least
//     kSplitRows rows each), and the last CTA of a (slot, kv head) to
//     finish (a counter) merges their partial softmax states, as B7 does:
//     one long slot no longer sets the step's attention time, and a few
//     kv heads fill the card; chunked prefill takes one
//     CTA per (kv head, tile of 16 of the C*g query rows) and reads keys
//     only up to its last row's causal limit;
//   - the key loop has a runtime trip count: ceil(len/32) tiles of 32 keys
//     (decode: the slot's length; chunk: start + row + 1), so the cost is
//     the live context, not max_context_len;
//   - a tile (32 contiguous rows) arrives as one 16-byte load per thread
//     and is dequantized once into shared memory (float32, padded rows: no
//     bank conflicts), used by every query row of the CTA; the next tile's
//     loads are issued before the current tile's math (register double
//     buffer), so their latency overlaps it;
//   - one lane per key computes the scores, then an online softmax in
//     float32 (running max and sum per row, in registers) rescales the
//     accumulator.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per tile: one per lane
constexpr int kMaxRows = 16;  // query rows per CTA
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kSplitRows = 256;  // least keys per CTA of a split decode walk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// B2 and B3 are instantiated for head dims up to MAXD = 128 and up to
// MAXD = 256 (gemma-2b's head_dim): the per-lane registers and the shared
// tiles are sized by MAXD.  The tiles are dynamic shared memory (82,688
// bytes at MAXD = 256, past the 48 KB of static shared memory).
template <int MAXD>
struct Smem {
  static constexpr int kBytes =
      (kMaxRows * MAXD + 2 * kTile * (MAXD + 1) + kWarps * kTile) * 4;
};

// A key/value tile in registers: 16-byte chunks of the contiguous rows
// t0..t0+31 of one (layer, slot, kv head), plus each chunk's scale.
template <int MAXD>
struct TileRegs {
  static constexpr int kChunks = kTile * MAXD * 2 / 16 / kThreads;
  uint4 k[kChunks], v[kChunks];
  float ksc[kChunks], vsc[kChunks];
};

// Issue the loads of rows [t0, t0 + nt): one 16-byte load per chunk (a
// chunk never straddles a row or a scale block: D % 16 == 0, blk % 16 == 0
// or blk == D).  Rows past nt read as zeros.
template <bool QUANT, int MAXD>
__device__ __forceinline__ void load_tile(TileRegs<MAXD>& r, const uint8_t* k_rows,
                                          const uint8_t* v_rows, const __half* k_sc,
                                          const __half* v_sc, int t0, int nt, int D,
                                          int blk, int tid) {
  const int row_bytes = QUANT ? D : 2 * D;
  const int valid = nt * row_bytes / 16;
  const uint4* kt = reinterpret_cast<const uint4*>(k_rows + (size_t)t0 * row_bytes);
  const uint4* vt = reinterpret_cast<const uint4*>(v_rows + (size_t)t0 * row_bytes);
#pragma unroll
  for (int c = 0; c < TileRegs<MAXD>::kChunks; ++c) {
    const int ch = tid + c * kThreads;
    r.k[c] = r.v[c] = make_uint4(0, 0, 0, 0);
    r.ksc[c] = r.vsc[c] = 0.f;
    if (ch < valid) {
      r.k[c] = __ldg(kt + ch);
      r.v[c] = __ldg(vt + ch);
      if (QUANT) {
        const int e0 = ch * 16;
        const int j = e0 / D, d0 = e0 - j * D;
        const size_t si = (size_t)(t0 + j) * (D / blk) + d0 / blk;
        r.ksc[c] = __half2float(k_sc[si]);
        r.vsc[c] = __half2float(v_sc[si]);
      }
    }
  }
}

// Dequantize the register tile into shared memory (float32).
template <bool QUANT, int MAXD>
__device__ __forceinline__ void store_tile(const TileRegs<MAXD>& r, float (*ks)[MAXD + 1],
                                           float (*vs)[MAXD + 1], int D, int tid) {
  constexpr int E = QUANT ? 16 : 8;  // elements per 16-byte chunk
  const int total = kTile * D / E;
#pragma unroll
  for (int c = 0; c < TileRegs<MAXD>::kChunks; ++c) {
    const int ch = tid + c * kThreads;
    if (ch < total) {
      const int e0 = ch * E;
      const int j = e0 / D, d0 = e0 - j * D;
      if (QUANT) {
        const int8_t* kq = reinterpret_cast<const int8_t*>(&r.k[c]);
        const int8_t* vq = reinterpret_cast<const int8_t*>(&r.v[c]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ks[j][d0 + e] = float(kq[e]) * r.ksc[c];
          vs[j][d0 + e] = float(vq[e]) * r.vsc[c];
        }
      } else {
        const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&r.k[c]);
        const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&r.v[c]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ks[j][d0 + e] = __bfloat162float(kh[e]);
          vs[j][d0 + e] = __bfloat162float(vh[e]);
        }
      }
    }
  }
}

// CHUNK = false (decode): grid (B, H, ceil(g / kMaxRows) * nsplit); rows
//   are query heads h*g + z*kMaxRows .. of kv head h of slot b = blockIdx.x
//   (z = blockIdx.z / nsplit: any number of query heads per kv head), every
//   row sees keys [0, lengths[b]), of which this CTA walks split
//   blockIdx.z % nsplit; part holds (B, H, groups, nsplit, R, D + 2)
//   floats (m, l, acc), R = min(g, kMaxRows), and counters (B, H, groups)
//   int32, zero on entry and left zero (both unused when nsplit is 1).
// CHUNK = true: grid (H, ceil(C*g / kMaxRows)); row r of kv head h is
//   chunk position c = r / g, query head h*g + r % g of slot `slot`, and
//   sees keys [0, start + c + 1).
// D <= MAXD, a multiple of 16.  At MAXD = 128 the kernel is held to four
// CTAs per SM (128 registers): left free, ptxas took 96 registers and the
// decode walk ran slower on the H100.  At MAXD = 256 the shared memory
// admits two.
template <bool QUANT, bool CHUNK, int MAXD>
__global__ void __launch_bounds__(kThreads, MAXD <= 128 ? 4 : 2)
attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                 const __half* __restrict__ k_scale, const void* __restrict__ v_cache,
                 const __half* __restrict__ v_scale, const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int layer, int B, int H, int S, int D,
                 int blk, int g, int slot, int start, int C, int nsplit, float scale) {
  constexpr int kDPerLane = MAXD / 32;
  extern __shared__ float smem[];
  __shared__ int last_s;
  float (*qs)[MAXD] = reinterpret_cast<float (*)[MAXD]>(smem);
  float (*ks)[MAXD + 1] = reinterpret_cast<float (*)[MAXD + 1]>(smem + kMaxRows * MAXD);
  float (*vs)[MAXD + 1] = ks + kTile;
  float (*ps)[kTile] = reinterpret_cast<float (*)[kTile]>(vs + kTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = H * g;

  int b, h, row0, n_rows, n_keys, key0 = 0, split = 0, ns = 1;
  if (CHUNK) {
    b = slot;
    h = blockIdx.x;
    row0 = blockIdx.y * kMaxRows;
    n_rows = min(kMaxRows, C * g - row0);
    n_keys = min(start + (row0 + n_rows - 1) / g + 1, S);
  } else {
    b = blockIdx.x;
    h = blockIdx.y;
    split = blockIdx.z % nsplit;
    row0 = (blockIdx.z / nsplit) * kMaxRows;
    n_rows = min(kMaxRows, g - row0);
    // whole tiles per CTA; a slot uses only the CTAs that get keys (one
    // for an empty slot, so that its output is written)
    const int len = min(max(lengths[b], 0), S);
    const int tiles = (len + kTile - 1) / kTile;
    const int want = min(nsplit, max(1, (len + kSplitRows - 1) / kSplitRows));
    const int per = max(1, (tiles + want - 1) / want);
    ns = max(1, (tiles + per - 1) / per);
    if (split >= ns) return;
    key0 = split * per * kTile;
    n_keys = min(len, key0 + per * kTile);
  }

  // (B, Hq, D) for decode, (C, Hq, D) for a chunk
  auto q_offset = [&](int i) -> size_t {
    if (CHUNK) {
      const int r = row0 + i;
      return ((size_t)(r / g) * hq + h * g + r % g) * D;
    }
    return ((size_t)b * hq + h * g + row0 + i) * D;
  };
  auto row_limit = [&](int i) -> int {
    if (CHUNK) return min(start + (row0 + i) / g + 1, S);
    return n_keys;
  };

  for (int idx = tid; idx < n_rows * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    qs[i][d] = __bfloat162float(q[q_offset(i) + d]);
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPerLane; ++dd) acc[rr][dd] = 0.f;
  }

  // rows of this (layer, slot, kv head) are contiguous: row t at head_row + t
  const size_t head_row = (((size_t)layer * B + b) * H + h) * S;
  const size_t row_bytes = QUANT ? D : 2 * D;
  const uint8_t* k_rows = static_cast<const uint8_t*>(k_cache) + head_row * row_bytes;
  const uint8_t* v_rows = static_cast<const uint8_t*>(v_cache) + head_row * row_bytes;
  const __half* k_sc = QUANT ? k_scale + head_row * (D / blk) : nullptr;
  const __half* v_sc = QUANT ? v_scale + head_row * (D / blk) : nullptr;

  // software pipeline: tile t+1's loads are in flight while tile t is used
  TileRegs<MAXD> regs;
  if (key0 < n_keys)
    load_tile<QUANT, MAXD>(regs, k_rows, v_rows, k_sc, v_sc, key0, min(kTile, n_keys - key0),
                           D, blk, tid);
  for (int t0 = key0; t0 < n_keys; t0 += kTile) {
    const int nt = min(kTile, n_keys - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    store_tile<QUANT, MAXD>(regs, ks, vs, D, tid);
    __syncthreads();
    if (t0 + kTile < n_keys)
      load_tile<QUANT, MAXD>(regs, k_rows, v_rows, k_sc, v_sc, t0 + kTile,
                       min(kTile, n_keys - t0 - kTile), D, blk, tid);

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = warp + rr * kWarps;
      const int limit = i < n_rows ? row_limit(i) : 0;
      if (t0 < limit) {  // warp-uniform
        const int pos = t0 + lane;
        float s = kNegInf;
        if (lane < nt && pos < limit) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qs[i][d], ks[lane][d], dot);
          s = dot * scale;
        }
        const float m_new = fmaxf(m_r[rr], warp_max(s));
        const float alpha = expf(m_r[rr] - m_new);
        const float p = expf(s - m_new);  // 0 for masked keys: the walk's
                                          // first key is always visible,
                                          // m_new is finite
        l_r[rr] = l_r[rr] * alpha + warp_sum(p);
        m_r[rr] = m_new;
        ps[warp][lane] = p;
        __syncwarp();
#pragma unroll
        for (int dd = 0; dd < kDPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (d < D) {
            float a = 0.f;
            for (int j = 0; j < nt; ++j) a = fmaf(ps[warp][j], vs[j][d], a);
            acc[rr][dd] = acc[rr][dd] * alpha + a;
          }
        }
        __syncwarp();
      }
    }
  }

  if (ns == 1) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = warp + rr * kWarps;
      if (i < n_rows) {
        const float inv = 1.f / fmaxf(l_r[rr], 1e-30f);
#pragma unroll
        for (int dd = 0; dd < kDPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (d < D) out[q_offset(i) + d] = __float2bfloat16_rn(acc[rr][dd] * inv);
        }
      }
    }
    return;
  }

  // a split walk (decode only): this CTA's partial state, then the last CTA
  // of the (slot, kv head, row group) merges the ns states of every row
  const int stride = D + 2;
  const int R = min(g, kMaxRows);
  const size_t cta = ((size_t)b * H + h) * (gridDim.z / nsplit) + blockIdx.z / nsplit;
  float* pz = part + (cta * nsplit + split) * R * (size_t)stride;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = warp + rr * kWarps;
    if (i < n_rows) {
      if (lane == 0) {
        pz[i * stride] = m_r[rr];
        pz[i * stride + 1] = l_r[rr];
      }
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) pz[i * stride + 2 + d] = acc[rr][dd];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[cta], 1) == ns - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* pb = part + cta * nsplit * R * (size_t)stride;
  for (int idx = tid; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float m = kNegInf;
    for (int zz = 0; zz < ns; ++zz)
      m = fmaxf(m, __ldcg(pb + ((size_t)zz * R + r) * stride));
    float l = 0.f, o = 0.f;
    for (int zz = 0; zz < ns; ++zz) {
      const float* pr = pb + ((size_t)zz * R + r) * stride;
      const float wt = expf(__ldcg(pr) - m);
      l += wt * __ldcg(pr + 1);
      o += wt * __ldcg(pr + 2 + d);
    }
    out[q_offset(r) + d] = __float2bfloat16_rn(o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counters[cta] = 0;
}

template <bool QUANT, bool CHUNK, int MAXD>
cudaError_t launch_d(dim3 grid, const void* q, const void* k, const void* ks,
                     const void* v, const void* vs, const void* lengths, void* out,
                     void* part, void* counters, int layer, int B, int H, int S, int D,
                     int blk, int g, int slot, int start, int C, int nsplit, float scale,
                     cudaStream_t stream) {
  auto kernel = attention_kernel<QUANT, CHUNK, MAXD>;
  constexpr int bytes = Smem<MAXD>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, static_cast<const __half*>(ks), v,
      static_cast<const __half*>(vs), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), layer, B, H, S, D, blk, g, slot, start, C, nsplit, scale);
  return cudaGetLastError();
}

// B2 / B3 for head_dim D (a multiple of 16 up to 256): the MAXD = 128
// instantiation up to 128, the MAXD = 256 one above.
template <bool CHUNK>
cudaError_t launch(dim3 grid, bool quantized, const void* q, const void* k,
                   const void* ks, const void* v, const void* vs, const void* lengths,
                   void* out, void* part, void* counters, int layer, int B, int H, int S,
                   int D, int blk, int g, int slot, int start, int C, int nsplit,
                   float scale, cudaStream_t stream) {
  if (D < 16 || D > 256 || D % 16 || g < 1 || nsplit < 1 ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)) ||
      (quantized && (blk < 16 || blk % 16 || D % blk)))
    return cudaErrorInvalidValue;
#define IFT_LAUNCH_D(QUANT, MAXD)                                                       \
  launch_d<QUANT, CHUNK, MAXD>(grid, q, k, ks, v, vs, lengths, out, part, counters, layer, \
                               B, H, S, D, blk, g, slot, start, C, nsplit, scale, stream)
  if (D <= 128) return quantized ? IFT_LAUNCH_D(true, 128) : IFT_LAUNCH_D(false, 128);
  return quantized ? IFT_LAUNCH_D(true, 256) : IFT_LAUNCH_D(false, 256);
#undef IFT_LAUNCH_D
}

// ------------------------------------------------------ paged decode (B7)
//
// Replaces inferflow_tpu/kernels/attention.py `_make_paged_kernel` (its
// pallas_call at :449, public entry `decode_attention` at :473 on a
// PagedKVCache): one-token attention of one layer over the page pool.
//
// Pool layout (runtime/paged_kv.py): k/v (L, P, H, PT, D) int8 codes or
// bf16, scales (L, P, H, PT, D/32) f16; row t of slot b lives in page
// page_table[b, t / PT] at row t % PT.  A page of one (layer, kv head) is
// one contiguous (PT, D) block.
//
// What bounds it: every live row of every (slot, kv head) is read once for
// ~4*D flops per query row, so it is bound by the pool bytes it reads.
//
// What the design does about it:
//   - the walk of each (slot, kv head) is split by length into up to
//     `nsplit` CTAs of whole pages (flash-decoding): a 32k-row slot is 16
//     CTAs of 16 pages, not one CTA walking 256 pages; CTAs a short slot
//     does not need return at once.  The last CTA of a (slot, head) to
//     finish (a counter) merges the partial softmax states;
//   - inside a CTA (8 warps, 4 for g > 8) each warp walks its own tiles
//     of 32 rows with its own
//     online-softmax state for the head's g query rows: lane j scores row
//     j from its own 16-byte loads of the K row, lane l accumulates output
//     dims [l*D/32, (l+1)*D/32) from one coalesced load per V row, and p
//     moves between the two by warp shuffles; no shared-memory staging of
//     K or V and no block-wide barrier in the walk.  Every load of a tile
//     (the K row, 32 V words, the scales) is issued before its math, so a
//     tile costs one memory latency, not one per V row; the warps' states
//     are merged in shared memory into one partial state per CTA;
//   - int8 codes become floats by the 2^23 magic-number trick (a byte
//     permute and one add) instead of the slower integer converts.

// warps per CTA: 8 while the merge buffer of the warps' states fits the
// 48 KB of static shared memory (g <= 8 at D <= 128, g = 1 at D = 256),
// else 4
template <int RM, int D>
__host__ __device__ constexpr int paged_warps() {
  return (D <= 128 ? RM <= 8 : RM <= 1) ? 8 : 4;
}
// query rows per CTA at most: a kv head's g rows are split into groups of
// this many (grid.y = H * groups), so that any g is served
template <int D>
__host__ __device__ constexpr int paged_max_rows() { return D <= 128 ? 16 : 8; }

struct PagedArgs {
  const __nv_bfloat16* q;   // (B, Hq, D)
  const void* k;            // (L, P, H, PT, D) int8 or bf16
  const void* v;
  const __half* k_scale;    // (L, P, H, PT, D / 32) f16 (quantized pools)
  const __half* v_scale;
  const int* page_table;    // (B, MAXP)
  const int* lengths;       // (B,)
  float* part;              // (B, H * groups, nsplit, RM, D + 2) per-CTA m, l, acc
  int* counters;            // (B, H * groups), zero on entry and on exit
  __nv_bfloat16* out;       // (B, Hq, D)
  int layer, B, H, P, PT, MAXP, g, nsplit;
  float scale;
};

// byte i of w (a signed int8) as a float, exactly: 2^23 + (byte ^ 0x80)
// read as a float, minus 2^23 + 128
__device__ __forceinline__ float i8_byte(uint32_t w, int i) {
  const uint32_t sel = 0x7650u | static_cast<uint32_t>(i);
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.f;
}

__device__ __forceinline__ float bf16_half(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ uint32_t chunk_word(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}

// element e of a 16-byte chunk: 16 int8 codes or 8 bf16 values
template <bool QUANT>
__device__ __forceinline__ float chunk_elem(const uint4& c, int e) {
  if (QUANT) return i8_byte(chunk_word(c, e / 4), e % 4);
  return bf16_half(chunk_word(c, e / 2), e % 2);
}

// The BYTES of one row that a lane accumulates (D/32 elements), as one load.
template <int BYTES> struct LaneWord;
template <> struct LaneWord<16> { using T = uint4; };
template <> struct LaneWord<8> { using T = uint2; };
template <> struct LaneWord<4> { using T = unsigned int; };
template <> struct LaneWord<2> { using T = unsigned short; };
template <> struct LaneWord<1> { using T = unsigned char; };

// element i of a lane word: an int8 code or a bf16 value
template <bool QUANT, typename W>
__device__ __forceinline__ float word_elem(const W& w, int i) {
  const int wi = i / (QUANT ? 4 : 2);  // the 32-bit word holding element i
  uint32_t x;
  if constexpr (sizeof(W) == 16)
    x = chunk_word(w, wi);  // bf16 at D = 256
  else if constexpr (sizeof(W) == 8)
    x = wi == 0 ? w.x : w.y;  // int8 at D = 256, bf16 at D = 128
  else
    x = static_cast<uint32_t>(w);
  if constexpr (QUANT)
    return i8_byte(x, i % 4);
  else
    return bf16_half(x, i % 2);
}

// grid (B, H * groups, nsplit): blockIdx.y = h * groups + group, the
// group's query rows group * RM .. of kv head h (RM >= the rows of a group).
template <bool QUANT, int D, int RM>
__global__ void __launch_bounds__(paged_warps<RM, D>() * 32)
    paged_attention_kernel(const PagedArgs a) {
  constexpr int kPagedWarps = paged_warps<RM, D>();
  constexpr int kPagedThreads = kPagedWarps * 32;
  constexpr int DL = D / 32;            // output dims per lane
  constexpr int NBLK = D / 32;          // scale blocks per row (blk = 32)
  constexpr int EB = QUANT ? 1 : 2;     // bytes per element
  constexpr int EPC = 16 / EB;          // elements per 16-byte chunk
  constexpr int CH = D / EPC;           // 16-byte chunks per row
  using W = typename LaneWord<DL * EB>::T;
  __shared__ __align__(16) float q_s[RM][D];
  __shared__ float vsc_s[kPagedWarps][kTile][NBLK];
  __shared__ float acc_s[kPagedWarps][RM][D];
  __shared__ float ml_s[kPagedWarps][RM][2];
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, z = blockIdx.z;
  const int groups = gridDim.y / a.H;
  const int h = blockIdx.y / groups;
  const int row_base = (blockIdx.y % groups) * RM;  // first query row of h
  const int hq = a.H * a.g;
  const int g = min(RM, a.g - row_base);  // this CTA's query rows
  const int len = min(max(a.lengths[b], 0), a.MAXP * a.PT);
  const int npages = (len + a.PT - 1) / a.PT;
  // whole pages per CTA; a slot uses only the CTAs that get pages (one
  // for an empty slot, so that its output is written)
  const int want = min(a.nsplit, max(npages, 1));
  const int per = max(1, (npages + want - 1) / want);
  const int nsplit = max(1, (npages + per - 1) / per);
  if (z >= nsplit) return;
  const int r0 = z * per * a.PT;
  const int r1 = min(len, (z + 1) * per * a.PT);

  for (int i = tid; i < g * D; i += kPagedThreads)
    q_s[i / D][i % D] =
        __bfloat162float(a.q[((size_t)b * hq + (size_t)h * a.g + row_base) * D + i]);
  __syncthreads();

  float m_r[RM], l_r[RM], acc[RM][DL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[r][dd] = 0.f;
  }

  const uint8_t* kbase = static_cast<const uint8_t*>(a.k);
  const uint8_t* vbase = static_cast<const uint8_t*>(a.v);
  const int cblk = lane * DL / 32;  // the scale block of this lane's dims
  for (int t0 = r0 + warp * kTile; t0 < r1; t0 += kPagedWarps * kTile) {
    const int nt = min(kTile, r1 - t0);  // >= 1
    const int pid = a.page_table[b * a.MAXP + t0 / a.PT];
    // the tile's 32 rows are contiguous and inside one page (t0 % 32 == 0,
    // PT % 32 == 0), so every lane may read its row even past nt
    const size_t row0 = (((size_t)a.layer * a.P + pid) * a.H + h) * a.PT + t0 % a.PT;

    // every load of the tile before any math: lane j's K row and scales,
    // this lane's dims of all 32 V rows, lane j's V scales
    uint4 kc[CH];
    const uint4* krow = reinterpret_cast<const uint4*>(kbase + (row0 + lane) * D * EB);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) kc[ch] = __ldg(krow + ch);
    W vw[kTile];
    const uint8_t* vcol = vbase + row0 * D * EB + lane * DL * EB;
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      vw[j] = __ldg(reinterpret_cast<const W*>(vcol + (size_t)j * D * EB));
    float ksc[NBLK];
#pragma unroll
    for (int c = 0; c < NBLK; ++c) {
      ksc[c] = 1.f;
      if (QUANT) {
        ksc[c] = __half2float(a.k_scale[(row0 + lane) * NBLK + c]);
        vsc_s[warp][lane][c] = __half2float(a.v_scale[(row0 + lane) * NBLK + c]);
      }
    }
    __syncwarp();

    // scores: lane j <-> row t0 + j
    // sum over scale blocks of (q . codes) * scale; q from shared memory
    // four floats at a time (broadcast)
    float s[RM], part[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = part[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
      for (int e4 = 0; e4 < EPC; e4 += 4) {
        float kv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = chunk_elem<QUANT>(kc[ch], e4 + e);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < g) {
            const float4 qv = *reinterpret_cast<const float4*>(&q_s[r][ch * EPC + e4]);
            part[r] = fmaf(qv.x, kv[0], part[r]);
            part[r] = fmaf(qv.y, kv[1], part[r]);
            part[r] = fmaf(qv.z, kv[2], part[r]);
            part[r] = fmaf(qv.w, kv[3], part[r]);
          }
        }
      }
      if ((ch + 1) * EPC % 32 == 0) {  // the end of scale block c
        const int c = ch * EPC / 32;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          s[r] = fmaf(part[r], ksc[c], s[r]);
          part[r] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = lane < nt ? s[r] * a.scale : kNegInf;

    // online softmax per query row; p stays in lane j's register
    float p[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < g) {
        const float m_new = fmaxf(m_r[r], warp_max(s[r]));
        const float alpha = expf(m_r[r] - m_new);
        p[r] = expf(s[r] - m_new);  // 0 past nt: lane 0 is always valid
        l_r[r] = l_r[r] * alpha + warp_sum(p[r]);
        m_r[r] = m_new;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) acc[r][dd] *= alpha;
      } else {
        p[r] = 0.f;
      }
    }

    // acc += p_j * vscale_j * v_j over the tile's rows
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nt) {  // warp-uniform
        const float vs = QUANT ? vsc_s[warp][j][cblk] : 1.f;
        float vf[DL];
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) vf[dd] = word_elem<QUANT>(vw[j], dd);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < g) {
            const float pj = __shfl_sync(0xffffffffu, p[r], j) * vs;
#pragma unroll
            for (int dd = 0; dd < DL; ++dd) acc[r][dd] = fmaf(pj, vf[dd], acc[r][dd]);
          }
        }
      }
    }
    __syncwarp();  // vsc_s is rewritten by the next tile
  }

  // merge the warps' states in shared memory into this CTA's partial state
  // part[(b, h), z]
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < g) {
      if (lane == 0) {
        ml_s[warp][r][0] = m_r[r];
        ml_s[warp][r][1] = l_r[r];
      }
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) acc_s[warp][r][lane * DL + dd] = acc[r][dd];
    }
  }
  __syncthreads();
  const int stride = D + 2;
  const size_t bh = (size_t)b * gridDim.y + blockIdx.y;
  float* pz = a.part + ((bh * a.nsplit + z) * RM) * (size_t)stride;
  for (int i = tid; i < g * D; i += kPagedThreads) {
    const int r = i / D, d = i - r * D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w) m = fmaxf(m, ml_s[w][r][0]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w) {
      const float wt = expf(ml_s[w][r][0] - m);
      l += wt * ml_s[w][r][1];
      o += wt * acc_s[w][r][d];
    }
    pz[r * stride + 2 + d] = o;
    if (d == 0) {
      pz[r * stride] = m;
      pz[r * stride + 1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&a.counters[bh], 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last CTA: merge the nsplit partial states of every row
  const float* pb = a.part + bh * a.nsplit * (size_t)RM * stride;
  for (int i = tid; i < g * D; i += kPagedThreads) {
    const int r = i / D, d = i - r * D;
    float m = kNegInf;
    for (int zz = 0; zz < nsplit; ++zz) m = fmaxf(m, __ldcg(pb + ((size_t)zz * RM + r) * stride));
    float l = 0.f, o = 0.f;
    for (int zz = 0; zz < nsplit; ++zz) {
      const float* pr = pb + ((size_t)zz * RM + r) * stride;
      const float wt = expf(__ldcg(pr) - m);
      l += wt * __ldcg(pr + 1);
      o += wt * __ldcg(pr + 2 + d);
    }
    a.out[((size_t)b * hq + (size_t)h * a.g + row_base + r) * D + d] =
        __float2bfloat16_rn(o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.counters[bh] = 0;
}

template <bool QUANT, int D, int RM>
void launch_paged_rm(const PagedArgs& a, dim3 grid, cudaStream_t stream) {
  paged_attention_kernel<QUANT, D, RM><<<grid, paged_warps<RM, D>() * 32, 0, stream>>>(a);
}

// grid.y = H * groups, groups = ceil(g / paged_max_rows<D>())
template <bool QUANT, int D>
cudaError_t launch_paged_d(const PagedArgs& a, int B, int nsplit, cudaStream_t stream) {
  constexpr int kRows = paged_max_rows<D>();
  const dim3 grid(B, a.H * ((a.g + kRows - 1) / kRows), nsplit);
  if (a.g <= 1)
    launch_paged_rm<QUANT, D, 1>(a, grid, stream);
  else if (a.g <= 8 || kRows == 8)
    launch_paged_rm<QUANT, D, 8>(a, grid, stream);
  else
    launch_paged_rm<QUANT, D, kRows>(a, grid, stream);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t launch_paged(const PagedArgs& a, int D, int B, int nsplit,
                         cudaStream_t stream) {
  switch (D) {
    case 32: return launch_paged_d<QUANT, 32>(a, B, nsplit, stream);
    case 64: return launch_paged_d<QUANT, 64>(a, B, nsplit, stream);
    case 128: return launch_paged_d<QUANT, 128>(a, B, nsplit, stream);
    case 256: return launch_paged_d<QUANT, 256>(a, B, nsplit, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D) bf16 -> out (B, Hq, D) bf16 over the page pool; page_table
// (B, MAXP) and lengths (B,) int32 on the device.  With R = 16 query rows
// per CTA at D <= 128 and 8 at D = 256, and groups = ceil(g / R): part
// holds B * H * groups * nsplit * R * (D + 2) floats; counters (B * H *
// groups int32) is zero on entry and is left zero.
int ift_paged_decode_attention(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* page_table, const void* lengths,
                               void* part, void* counters, void* out, int layer, int B, int H,
                               int P, int PT, int MAXP, int D, int g, int nsplit,
                               int quantized, float scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || MAXP < 1 || PT < kTile || PT % kTile || g < 1 ||
      nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k, a.v = v;
  a.k_scale = static_cast<const __half*>(ks), a.v_scale = static_cast<const __half*>(vs);
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer, a.B = B, a.H = H, a.P = P, a.PT = PT, a.MAXP = MAXP, a.g = g;
  a.nsplit = nsplit, a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantized ? launch_paged<true>(a, D, B, nsplit, st)
                                    : launch_paged<false>(a, D, B, nsplit, st);
  return static_cast<int>(err);
}

// q (B, Hq, D) bf16 -> out (B, Hq, D) bf16; lengths (B,) int32 on device.
// Each slot's walk is split over up to nsplit CTAs; with groups =
// ceil(g / 16), part holds B * H * groups * nsplit * min(g, 16) * (D + 2)
// floats and
// counters B * H * groups int32, zero on entry and left zero (both may be
// null when nsplit is 1).
int ift_decode_attention(const void* q, const void* k, const void* ks, const void* v,
                         const void* vs, const void* lengths, void* part, void* counters,
                         void* out, int layer, int B, int H, int S, int D, int blk, int g,
                         int nsplit, int quantized, float scale, void* stream) {
  const int groups = (g + kMaxRows - 1) / kMaxRows;
  if (nsplit < 1 || (long long)groups * nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, H, groups * nsplit);
  return static_cast<int>(launch<false>(grid, quantized != 0, q, k, ks, v, vs, lengths,
                                        out, part, counters, layer, B, H, S, D, blk, g,
                                        0, 0, 1, nsplit, scale,
                                        static_cast<cudaStream_t>(stream)));
}

// q (C, Hq, D) bf16 of slot `slot` at positions start..start+C-1 ->
// out (C, Hq, D) bf16.
int ift_chunk_attention(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, void* out, int layer, int B, int H, int S,
                        int D, int blk, int g, int slot, int start, int C, int quantized,
                        float scale, void* stream) {
  dim3 grid(H, (C * g + kMaxRows - 1) / kMaxRows);
  return static_cast<int>(launch<true>(grid, quantized != 0, q, k, ks, v, vs, nullptr,
                                       out, nullptr, nullptr, layer, B, H, S, D, blk, g,
                                       slot, start, C, 1, scale,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
