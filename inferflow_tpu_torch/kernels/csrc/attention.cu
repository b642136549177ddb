// Attention over the stacked KV cache: single-token decode (B2), the
// chunked-prefill flash attention of one slot's query chunk (B3, its own
// section below, on the tensor cores); and single-token decode over the
// paged pool (B7).
//
// Replaces inferflow_tpu/kernels/attention.py `_make_kernel` (pallas_call at
// :259, public entry `decode_attention` at :473) and `_make_chunk_kernel`
// (pallas_call at :681, public entry `chunk_attention` at :706).
//
// Cache layout (the logical one; no sequence packing):
//   k, v        (L, B, H, S, D) int8 codes, or bf16 for an unquantized cache
//   k/v scales  (L, B, H, S, D/blk) f16, one per blk-element block of a row
// The layer index is an argument: the kernels read the whole stacked cache
// in place, no per-layer copy.  B2 and B7 dequantize each key/value element
// on read as code*scale in float32 (exact: an 8-bit code times an f16
// scale).
//
// What bounds B2 on the H100: decode reads every live cache row of every
// (slot, kv head) once and does ~4*D flops per row per query row, far below
// the card's flops per byte: it is bound by the int8 cache bytes (plus the
// f16 scales).
//
// What B2's design does about it:
//   - one CTA per (slot, kv head) serves that head's g query rows (GQA)
//     from one read of the K/V rows; each slot's walk is split by length
//     into up to `nsplit` CTAs of whole tiles (at least kSplitRows rows
//     each), and the last CTA of a (slot, kv head) to finish (a counter)
//     merges their partial softmax states, as B7 does: one long slot no
//     longer sets the step's attention time, and a few kv heads fill the
//     card;
//   - the key loop has a runtime trip count: ceil(len/32) tiles of 32 keys,
//     so the cost is the live context, not max_context_len;
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
#include <math.h>
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

// B2 is instantiated for head dims up to MAXD = 128 and up to MAXD = 256
// (gemma-2b's head_dim): the per-lane registers and the shared tiles are
// sized by MAXD.  The tiles are dynamic shared memory (82,688
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

// grid (B, H, ceil(g / kMaxRows) * nsplit); rows are query heads
// h*g + z*kMaxRows .. of kv head h of slot b = blockIdx.x (z = blockIdx.z /
// nsplit: any number of query heads per kv head), every row sees keys
// [0, lengths[b]), of which this CTA walks split blockIdx.z % nsplit; part
// holds (B, H, groups, nsplit, R, D + 2) floats (m, l, acc), R = min(g,
// kMaxRows), and counters (B, H, groups) int32, zero on entry and left
// zero (both unused when nsplit is 1).
// D <= MAXD, a multiple of 16.  At MAXD = 128 the kernel is held to four
// CTAs per SM (128 registers): left free, ptxas took 96 registers and the
// decode walk ran slower on the H100.  At MAXD = 256 the shared memory
// admits two.
template <bool QUANT, int MAXD>
__global__ void __launch_bounds__(kThreads, MAXD <= 128 ? 4 : 2)
attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                 const __half* __restrict__ k_scale, const void* __restrict__ v_cache,
                 const __half* __restrict__ v_scale, const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int layer, int B, int H, int S, int D,
                 int blk, int g, int nsplit, float scale) {
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

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z % nsplit;
  const int row0 = (blockIdx.z / nsplit) * kMaxRows;
  const int n_rows = min(kMaxRows, g - row0);
  // whole tiles per CTA; a slot uses only the CTAs that get keys (one for
  // an empty slot, so that its output is written)
  const int len = min(max(lengths[b], 0), S);
  const int tiles = (len + kTile - 1) / kTile;
  const int want = min(nsplit, max(1, (len + kSplitRows - 1) / kSplitRows));
  const int per = max(1, (tiles + want - 1) / want);
  const int ns = max(1, (tiles + per - 1) / per);
  if (split >= ns) return;
  const int key0 = split * per * kTile;
  const int n_keys = min(len, key0 + per * kTile);

  // (B, Hq, D)
  auto q_offset = [&](int i) -> size_t {
    return ((size_t)b * hq + h * g + row0 + i) * D;
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
      if (i < n_rows) {  // warp-uniform
        const int pos = t0 + lane;
        float s = kNegInf;
        if (lane < nt && pos < n_keys) {
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

  // a split walk: this CTA's partial state, then the last CTA of the
  // (slot, kv head, row group) merges the ns states of every row
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

template <bool QUANT, int MAXD>
cudaError_t launch_d(dim3 grid, const void* q, const void* k, const void* ks,
                     const void* v, const void* vs, const void* lengths, void* out,
                     void* part, void* counters, int layer, int B, int H, int S, int D,
                     int blk, int g, int nsplit, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<QUANT, MAXD>;
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
      static_cast<int*>(counters), layer, B, H, S, D, blk, g, nsplit, scale);
  return cudaGetLastError();
}

// B2 for head_dim D (a multiple of 16 up to 256): the MAXD = 128
// instantiation up to 128, the MAXD = 256 one above.
cudaError_t launch(dim3 grid, bool quantized, const void* q, const void* k,
                   const void* ks, const void* v, const void* vs, const void* lengths,
                   void* out, void* part, void* counters, int layer, int B, int H, int S,
                   int D, int blk, int g, int nsplit, float scale, cudaStream_t stream) {
  if (D < 16 || D > 256 || D % 16 || g < 1 || nsplit < 1 ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)) ||
      (quantized && (blk < 16 || blk % 16 || D % blk)))
    return cudaErrorInvalidValue;
#define IFT_LAUNCH_D(QUANT, MAXD)                                                 \
  launch_d<QUANT, MAXD>(grid, q, k, ks, v, vs, lengths, out, part, counters, layer, B, \
                        H, S, D, blk, g, nsplit, scale, stream)
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

// ------------------------------------------------ chunked prefill (B3)
//
// C query rows of one slot attend to that slot's cache rows [0, start + c
// + 1), c the row's chunk position; a kv head's rows are its C*g query
// rows, row r = (chunk position r / g, query head h*g + r % g).
//
// What bounds it on the H100: a 256-row chunk reuses every cached row for
// C*g query rows (~4*D operations per row pair): at llama2-13b width and
// row 1536 it is 8.7 GFLOP against 0.6 MB of cache, far above the card's
// bf16 operations per byte, so it is bound by the tensor cores.
//
// What the design does about it (FlashAttention-2's shape on mma.sync):
//   - a CTA of 4 warps owns 64 of a kv head's C*g rows, 16 per warp; the
//     scores S = Q K^T and the product P V are bf16 mma.sync.m16n8k16 with
//     float32 accumulators, fragments from shared memory by ldmatrix
//     (.trans for V); Q stays in shared memory and each k-step loads its
//     fragment there (at D = 256 the 16 x 256 float32 accumulator takes 128
//     registers per thread);
//   - key tiles of chunk_tile<MAXD>() rows (64 up to D = 128, 32 at 256)
//     come in by cp.async while the previous tile is used: a bf16 cache's
//     into a second pair of tiles; a Q8 cache's int8 rows into one raw
//     stage, widened once per CTA into the bf16 tiles (the 2^23
//     magic-number trick, exact), after which the next tile's copy starts;
//     the scales' f16 bits come one tile ahead into registers;
//   - the serving head dims (64, 128, 256, with the cache's 32-element
//     scale blocks) are compiled with D fixed, so every index is a shift;
//     other multiples of 16 run the MAXD = 64, 128 or 256 instantiation
//     with D read at run time;
//   - scores are formed on codes as the TPU kernel forms them (:586-598):
//     the products of each blk-wide slice of D accumulate in float32 on
//     the raw codes (exact in bf16, as is q), and each slice's sum is
//     multiplied by that key's k_scale for the slice, then by the softmax
//     scale.  Each product is exact; the scores differ from the TPU
//     formula in summation order only;
//   - P V: V is dequantized once per CTA into the bf16 tile, v =
//     bf16(code * v_scale), and P is rounded to bf16 for the MMA: each term
//     p * v carries two roundings of at most 2^-9 relative (P's and V's),
//     summed in float32 (tests/test_torch_b3_rounding.py emulates this
//     arithmetic on the CPU and holds it against the TPU kernel: well
//     inside 8e-3 * max|ref|).  A bf16 cache takes K and V as stored;
//   - the online softmax stays in registers (exp2 of scores in log2
//     units); a row's max and sum take only the quad shuffles of the mma
//     layout; a warp skips a tile past all of its rows' causal limits and
//     masks only the tiles that cross one;
//   - the key walk is split over `nsplit` CTAs of whole tiles when the
//     (H, ceil(C*g / 64)) grid's splits all fit on the card at once (the
//     wrapper picks it from the runtime's occupancy,
//     ift_chunk_ctas_per_sm: attention.chunk_split); each writes a
//     partial (m, l, acc) per row, and the last CTA of a row block to
//     finish (a counter) merges them, as B2 does, with every split's rows
//     in flight at once.  The row
//     blocks with the longest causal walks have the lowest block indices,
//     so they start first.

constexpr int kChunkRows = 64;         // query rows per CTA (4 warps x 16)
constexpr int kMaxChunkSplit = 16;     // CTAs per row block's walk at most
template <int MAXD>
__host__ __device__ constexpr int chunk_tile() { return MAXD > 128 ? 32 : 64; }

// B3's dynamic shared memory, in bytes from its start, for key tiles of
// bn rows, head_dim d and nb scale blocks per row (the host sizes the
// launch with it, the kernel carves with it): Q (64 rows) and the bf16 K
// and V tiles, rows of d + 8 elements (ldmatrix without bank conflicts);
// a bf16 cache double-buffers the K/V tiles (kv[stage][k or v] from kb);
// a Q8 cache has one bf16 K/V tile, one stage of raw int8 K/V rows (the
// next tile's copy starts once this one is widened) and two stages of
// float scales ([stage][k or v][block][key]).
struct ChunkLayout {
  int kb, vb, raw, sc, bytes;
  __host__ __device__ ChunkLayout(bool quant, int bn, int d, int nb) {
    const int ld = d + 8, tile = bn * ld * 2;
    kb = kChunkRows * ld * 2;
    vb = kb + tile;
    raw = vb + tile;
    sc = raw + 2 * bn * d;
    bytes = quant ? sc + 2 * 2 * nb * bn * 4 : kb + 4 * tile;
  }
};

struct ChunkArgs {
  const __nv_bfloat16* q;   // (C, Hq, D)
  const void* k;            // (L, B, H, S, D) int8 or bf16
  const void* v;
  const __half* k_scale;    // (L, B, H, S, D / blk) f16 (Q8 cache)
  const __half* v_scale;
  float* part;              // (H, RB, nsplit, 64, D + 4): m, l, -, -, acc
  int* counters;            // (H, RB), zero on entry and on exit
  __nv_bfloat16* out;       // (C, Hq, D)
  int layer, B, H, S, D, blk, g, slot, start, C, nsplit;
  float scale_log2;         // softmax scale times log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (no bytes read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 int8 codes (a 32-bit word) as two bf16x2 words, exactly: each code as
// the float 2^23 + (byte ^ 0x80) - (2^23 + 128), whose low 16 bits are
// zero (|code| <= 128 has at most 7 significant bits), so its bf16 is its
// high half
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const float f0 = i8_byte(w, 0), f1 = i8_byte(w, 1), f2 = i8_byte(w, 2), f3 = i8_byte(w, 3);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// grid (nsplit, H, RB = ceil(C*g / 64)): blockIdx.z = RB - 1 - row block,
// blockIdx.y = kv head, blockIdx.x = this CTA's share of the key walk.
// DT and BLKT fix head_dim and the scale block at compile time (0: read
// from the arguments): every index then folds to shifts and constants.
template <bool QUANT, int MAXD, int DT, int BLKT>
__global__ void __launch_bounds__(kThreads, MAXD <= 64 ? 3 : 2)
chunk_attention_kernel(const ChunkArgs a) {
  constexpr int BN = chunk_tile<MAXD>();
  constexpr int NT = BN / 8;       // score n-tiles per key tile
  constexpr int KS = MAXD / 16;    // k-steps over D at most
  constexpr int OT = MAXD / 8;     // output n-tiles at most
  constexpr int kScReg = (BN * (MAXD / 16) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = DT ? DT : a.D, g = a.g, ld = D + 8;
  const int blk = QUANT ? (BLKT ? BLKT : a.blk) : D;
  const int nb = D / blk;
  const int hq = a.H * g;
  const int rows = a.C * g;
  const int RB = gridDim.z;
  const int rb = RB - 1 - blockIdx.z;
  const int h = blockIdx.y;
  const int z = blockIdx.x;
  const int row0 = rb * kChunkRows;
  const int n_rows = min(kChunkRows, rows - row0);
  // keys this row block sees at most: its last row's causal limit
  const int n_keys = min(a.start + (row0 + n_rows - 1) / g + 1, a.S);
  const int tiles = (n_keys + BN - 1) / BN;
  const int per = (tiles + a.nsplit - 1) / a.nsplit;
  const int ns = (tiles + per - 1) / per;  // CTAs that get tiles
  if (z >= ns) return;
  const int tile0 = z * per, tile1 = min(tiles, tile0 + per);

  const ChunkLayout lay(QUANT, BN, D, nb);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(chunk_smem);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(chunk_smem + lay.kb);
  __nv_bfloat16* vb = reinterpret_cast<__nv_bfloat16*>(chunk_smem + lay.vb);
  int8_t* raw = reinterpret_cast<int8_t*>(chunk_smem + lay.raw);
  float* scs = reinterpret_cast<float*>(chunk_smem + lay.sc);
  const int tile_elems = BN * ld;  // one bf16 K or V tile

  auto q_offset = [&](int r) -> size_t {
    return ((size_t)(r / g) * hq + h * g + r % g) * D;
  };
  const size_t head_row = (((size_t)a.layer * a.B + a.slot) * a.H + h) * a.S;
  constexpr int EB = QUANT ? 1 : 2;  // bytes per cached element
  const uint8_t* k_rows = static_cast<const uint8_t*>(a.k) + head_row * D * EB;
  const uint8_t* v_rows = static_cast<const uint8_t*>(a.v) + head_row * D * EB;
  const __half* k_sc = QUANT ? a.k_scale + head_row * nb : nullptr;
  const __half* v_sc = QUANT ? a.v_scale + head_row * nb : nullptr;

  // tile t's K and V rows (zeros past n_keys), one group: a Q8 cache's
  // into the raw rows, a bf16 cache's into stage st's tiles
  auto copy_tile = [&](int t, int st) {
    const int t0 = t * BN;
    const int cpr = D * EB / 16;  // 16-byte chunks per row
    for (int c = tid; c < BN * cpr; c += kThreads) {
      const int j = c / cpr, cc = c - j * cpr;
      const bool valid = t0 + j < n_keys;
      const size_t off = valid ? (size_t)(t0 + j) * D * EB + cc * 16 : 0;
      unsigned char *dk, *dv;
      if constexpr (QUANT) {
        dk = reinterpret_cast<unsigned char*>(raw) + j * D + cc * 16;
        dv = dk + BN * D;
      } else {
        dk = reinterpret_cast<unsigned char*>(kb + 2 * st * tile_elems + j * ld) + cc * 16;
        dv = dk + tile_elems * 2;
      }
      cp_async16(dk, k_rows + off, valid);
      cp_async16(dv, v_rows + off, valid);
    }
    cp_async_commit();
  };
  // a Q8 tile's scales: their f16 bits loaded into registers one tile
  // ahead (nothing reads them until the next tile: the loads stay in
  // flight), stored as floats into sc[stage] ([block][key]) before the
  // tile is used
  unsigned short ksr[kScReg], vsr[kScReg];
  auto load_scales = [&](int t) {
    const int t0 = t * BN;
    const unsigned short* kbits = reinterpret_cast<const unsigned short*>(k_sc);
    const unsigned short* vbits = reinterpret_cast<const unsigned short*>(v_sc);
#pragma unroll
    for (int i = 0; i < kScReg; ++i) {
      const int idx = tid + i * kThreads;
      const int j = idx / nb, bi = idx - j * nb;
      ksr[i] = vsr[i] = 0;
      if (idx < BN * nb && t0 + j < n_keys) {
        ksr[i] = __ldg(kbits + (size_t)(t0 + j) * nb + bi);
        vsr[i] = __ldg(vbits + (size_t)(t0 + j) * nb + bi);
      }
    }
  };
  auto store_scales = [&](int st) {
    float* ksf = scs + 2 * st * nb * BN;
#pragma unroll
    for (int i = 0; i < kScReg; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < BN * nb) {
        const int j = idx / nb, bi = idx - j * nb;
        ksf[bi * BN + j] = __half2float(__ushort_as_half(ksr[i]));
        ksf[nb * BN + bi * BN + j] = __half2float(__ushort_as_half(vsr[i]));
      }
    }
  };

  // Q rows of this block (zeros for rows past C*g) join tile0's group
  {
    const int cpr = D / 8;
    for (int c = tid; c < kChunkRows * cpr; c += kThreads) {
      const int r = c / cpr, cc = c - r * cpr;
      const bool valid = r < n_rows;
      cp_async16(qs + r * ld + cc * 8, valid ? a.q + q_offset(row0 + r) + cc * 8 : a.q, valid);
    }
  }
  copy_tile(tile0, 0);
  if constexpr (QUANT) load_scales(tile0);

  // this thread's rows (mma layout): wr0 + lane/4 and + 8
  const int wr0 = row0 + warp * 16;
  const bool warp_live = wr0 < rows;
  const int wlast = min(wr0 + 15, rows - 1);
  const int warp_lim_lo = min(a.start + wr0 / g + 1, a.S);    // its first row's limit
  const int warp_lim_hi = min(a.start + wlast / g + 1, a.S);  // its last row's
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + lane / 4 + 8 * hh;
    lim[hh] = min(a.start + r / g + 1, a.S);
  }
  const int qd = lane % 4;  // the column pair 2*qd of each 8-wide n-tile
  // ldmatrix lane offsets: A (Q) and B (K) x4, and V x4.trans
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = lr + (lm & 1) * 8, a_col = (lm >> 1) * 8;
  const int b_key = lr + (lm >> 1) * 8, b_col = (lm & 1) * 8;
  const int v_key = lr + (lm & 1) * 8, v_col = (lm >> 1) * 8;

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = tile0; t < tile1; ++t) {
    const int cur = (t - tile0) & 1;
    cp_async_wait_all();  // tile t (and Q) landed, this thread's copies
    if constexpr (QUANT) store_scales(cur);
    __syncthreads();  // every copy visible; tile t-1's math done everywhere
    const __nv_bfloat16 *kt, *vt;
    const float* ksf = scs + 2 * cur * nb * BN;
    if constexpr (QUANT) {
      // widen the codes once: K exactly, V times its scale, rounded to bf16
      const int8_t* rk = raw;
      const int8_t* rv = raw + BN * D;
      const float* vsf = ksf + nb * BN;
      const int cpr = D / 16;
      for (int c = tid; c < BN * cpr; c += kThreads) {
        const int j = c / cpr, d0 = (c - j * cpr) * 16;
        const uint4 kw = *reinterpret_cast<const uint4*>(rk + j * D + d0);
        const uint4 vw = *reinterpret_cast<const uint4*>(rv + j * D + d0);
        uint4 k0, k1;
        codes_to_bf16(kw.x, k0.x, k0.y);
        codes_to_bf16(kw.y, k0.z, k0.w);
        codes_to_bf16(kw.z, k1.x, k1.y);
        codes_to_bf16(kw.w, k1.z, k1.w);
        const float vs = vsf[(d0 / blk) * BN + j];
        uint32_t vv[8];
        const uint32_t vwords[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[2 * i] = pack_bf16(i8_byte(vwords[i], 0) * vs, i8_byte(vwords[i], 1) * vs);
          vv[2 * i + 1] = pack_bf16(i8_byte(vwords[i], 2) * vs, i8_byte(vwords[i], 3) * vs);
        }
        uint4* kd = reinterpret_cast<uint4*>(kb + j * ld + d0);
        uint4* vd = reinterpret_cast<uint4*>(vb + j * ld + d0);
        kd[0] = k0;
        kd[1] = k1;
        vd[0] = make_uint4(vv[0], vv[1], vv[2], vv[3]);
        vd[1] = make_uint4(vv[4], vv[5], vv[6], vv[7]);
      }
      __syncthreads();  // the raw rows are free, the bf16 tiles ready
      if (t + 1 < tile1) {
        copy_tile(t + 1, 0);
        load_scales(t + 1);
      }
      kt = kb;
      vt = vb;
    } else {
      if (t + 1 < tile1) copy_tile(t + 1, cur ^ 1);
      kt = kb + 2 * cur * tile_elems;
      vt = kt + tile_elems;
    }

    const int t0 = t * BN;
    if (!warp_live || t0 >= warp_lim_hi) continue;  // warp-uniform

    // S = Q K^T; for a Q8 cache each blk-wide slice of D is summed on the
    // codes, then scaled by the key's k_scale for that slice
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    float tmp[QUANT ? NT : 1][4];
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < NT; ++j) tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
    }
    const int kpb = blk / 16;  // k-steps per scale block
    int kin = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks * 16 < D) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qs + (warp * 16 + a_row) * ld + ks * 16 + a_col);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + (jj * 16 + b_key) * ld + ks * 16 + b_col);
          if constexpr (QUANT) {
            mma_bf16(tmp[2 * jj], qa, kf[0], kf[1]);
            mma_bf16(tmp[2 * jj + 1], qa, kf[2], kf[3]);
          } else {
            mma_bf16(s[2 * jj], qa, kf[0], kf[1]);
            mma_bf16(s[2 * jj + 1], qa, kf[2], kf[3]);
          }
        }
        if constexpr (QUANT) {
          if (++kin == kpb) {  // the end of scale block ks*16 / blk
            kin = 0;
            const float* kscl = ksf + ((ks * 16) / blk) * BN + 2 * qd;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2 sc = *reinterpret_cast<const float2*>(kscl + 8 * j);
              s[j][0] = fmaf(tmp[j][0], sc.x, s[j][0]);
              s[j][1] = fmaf(tmp[j][1], sc.y, s[j][1]);
              s[j][2] = fmaf(tmp[j][2], sc.x, s[j][2]);
              s[j][3] = fmaf(tmp[j][3], sc.y, s[j][3]);
              tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
            }
          }
        }
      }
    }

    // scores in log2 units, masked past each row's causal limit
    const bool masked = t0 + BN > warp_lim_lo;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * a.scale_log2;
        if (masked && t0 + 8 * j + 2 * qd + (e & 1) >= lim[e >> 1]) v = -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      // a row that has seen no visible key yet keeps m = -inf: exp2 of
      // its masked scores must give 0, not 1
      m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = fast_exp2(m_r[hh] - m_use[hh]);
      m_r[hh] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P's score fragments become the A fragments of 16 keys
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      pa[i][0] = pack_bf16(s[2 * i][0], s[2 * i][1]);
      pa[i][1] = pack_bf16(s[2 * i][2], s[2 * i][3]);
      pa[i][2] = pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]);
      pa[i][3] = pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3]);
    }
#pragma unroll
    for (int n2 = 0; n2 < OT / 2; ++n2) {
      if (n2 * 16 < D) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (i * 16 + v_key) * ld + n2 * 16 + v_col);
          mma_bf16(o[2 * n2], pa[i], vf[0], vf[1]);
          mma_bf16(o[2 * n2 + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
  }

  // each row's sum over its quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 1);
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 2);
  }

  if (ns == 1) {
    if (!warp_live) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr0 + lane / 4 + 8 * hh;
      if (r < rows) {
        const float inv = 1.f / fmaxf(l_r[hh], 1e-30f);
        __nv_bfloat16* orow = a.out + q_offset(r);
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          const int d = 8 * j + 2 * qd;
          if (d < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
        }
      }
    }
    return;
  }

  // a split walk: this CTA's partial state per row (m, l at 0 and 1, the
  // accumulator from 4: 16-byte aligned rows), then the last CTA of the
  // row block merges the ns states
  const int stride = D + 4;
  const size_t grp = (size_t)h * RB + rb;
  float* pz = a.part + ((grp * a.nsplit + z) * kChunkRows) * (size_t)stride;
  if (warp_live) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = warp * 16 + lane / 4 + 8 * hh;  // row within the block
      if (rl < n_rows) {
        float* pr = pz + (size_t)rl * stride;
        if (qd == 0) {
          pr[0] = m_r[hh];
          pr[1] = l_r[hh];
        }
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          const int d = 8 * j + 2 * qd;
          if (d < D) *reinterpret_cast<float2*>(pr + 4 + d) = make_float2(o[j][2 * hh], o[j][2 * hh + 1]);
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&a.counters[grp], 1) == ns - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last CTA: per row the weight of each split, exp2(m_z - m) / l
  // (the shared memory is free now), then every 4 elements of a row, two
  // items per thread at a time with every split's loads in flight
  const float* pb = a.part + grp * a.nsplit * (size_t)kChunkRows * stride;
  float* wts = reinterpret_cast<float*>(chunk_smem);  // [64][nsplit]
  if (tid < n_rows) {
    const int r = tid;
    float m = -INFINITY;
    for (int zz = 0; zz < ns; ++zz)
      m = fmaxf(m, __ldcg(pb + ((size_t)zz * kChunkRows + r) * stride));
    float l = 0.f;
    for (int zz = 0; zz < ns; ++zz) {
      const float* pr = pb + ((size_t)zz * kChunkRows + r) * stride;
      const float wt = fast_exp2(__ldcg(pr) - m);
      wts[r * a.nsplit + zz] = wt;
      l += wt * __ldcg(pr + 1);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int zz = 0; zz < ns; ++zz) wts[r * a.nsplit + zz] *= inv;
  }
  __syncthreads();
  const int q4 = D / 4;
  for (int i0 = tid; i0 < n_rows * q4; i0 += 2 * kThreads) {
    float4 v[2][kMaxChunkSplit];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_rows * q4) {
        const int r = i / q4, d = 4 * (i - r * q4);
#pragma unroll
        for (int zz = 0; zz < kMaxChunkSplit; ++zz)
          if (zz < ns)
            v[u][zz] = __ldcg(reinterpret_cast<const float4*>(
                pb + ((size_t)zz * kChunkRows + r) * stride + 4 + d));
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_rows * q4) {
        const int r = i / q4, d = 4 * (i - r * q4);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int zz = 0; zz < kMaxChunkSplit; ++zz) {
          if (zz < ns) {
            const float wt = wts[r * a.nsplit + zz];
            acc.x = fmaf(wt, v[u][zz].x, acc.x);
            acc.y = fmaf(wt, v[u][zz].y, acc.y);
            acc.z = fmaf(wt, v[u][zz].z, acc.z);
            acc.w = fmaf(wt, v[u][zz].w, acc.w);
          }
        }
        __nv_bfloat162* orow =
            reinterpret_cast<__nv_bfloat162*>(a.out + q_offset(row0 + r) + d);
        orow[0] = __floats2bfloat162_rn(acc.x, acc.y);
        orow[1] = __floats2bfloat162_rn(acc.z, acc.w);
      }
    }
  }
  if (tid == 0) a.counters[grp] = 0;
}

// launches, or with per_sm set, writes the CTAs one SM holds at once
template <bool QUANT, int MAXD, int DT, int BLKT>
cudaError_t launch_chunk_d(const ChunkArgs& a, dim3 grid, cudaStream_t stream, int* per_sm) {
  auto kernel = chunk_attention_kernel<QUANT, MAXD, DT, BLKT>;
  constexpr int BN = chunk_tile<MAXD>();
  // the most any D <= MAXD takes (16-row scale blocks), set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ChunkLayout(QUANT, BN, MAXD, MAXD / 16).bytes);
  if (attr != cudaSuccess) return attr;
  const int bytes = ChunkLayout(QUANT, BN, a.D, QUANT ? a.D / a.blk : 1).bytes;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, bytes);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// B3 for head_dim D (a multiple of 16 up to 256): the serving head dims
// 64, 128 and 256 (with 32-element scale blocks for a Q8 cache, the KV
// cache's) fixed at compile time, any other D on the MAXD = 64, 128 or
// 256 instantiation that holds it.
template <bool QUANT>
cudaError_t launch_chunk(const ChunkArgs& a, dim3 grid, cudaStream_t stream,
                         int* per_sm = nullptr) {
  constexpr int kBlk = QUANT ? 32 : 0;
  if (!QUANT || a.blk == 32) {
    if (a.D == 64) return launch_chunk_d<QUANT, 64, 64, kBlk>(a, grid, stream, per_sm);
    if (a.D == 128) return launch_chunk_d<QUANT, 128, 128, kBlk>(a, grid, stream, per_sm);
    if (a.D == 256) return launch_chunk_d<QUANT, 256, 256, kBlk>(a, grid, stream, per_sm);
  }
  if (a.D <= 64) return launch_chunk_d<QUANT, 64, 0, 0>(a, grid, stream, per_sm);
  if (a.D <= 128) return launch_chunk_d<QUANT, 128, 0, 0>(a, grid, stream, per_sm);
  return launch_chunk_d<QUANT, 256, 0, 0>(a, grid, stream, per_sm);
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
  return static_cast<int>(launch(grid, quantized != 0, q, k, ks, v, vs, lengths, out, part,
                                 counters, layer, B, H, S, D, blk, g, nsplit, scale,
                                 static_cast<cudaStream_t>(stream)));
}

// q (C, Hq, D) bf16 of slot `slot` at positions start..start+C-1 ->
// out (C, Hq, D) bf16.  Each row block's key walk is split over up to
// nsplit CTAs; with RB = ceil(C*g / 64), part holds H * RB * nsplit * 64 *
// (D + 4) floats and counters H * RB int32, zero on entry and left zero
// (both may be null when nsplit is 1).
int ift_chunk_attention(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, void* part, void* counters, void* out, int layer,
                        int B, int H, int S, int D, int blk, int g, int slot, int start,
                        int C, int nsplit, int quantized, float scale, void* stream) {
  const long long rb = ((long long)C * g + kChunkRows - 1) / kChunkRows;
  if (D < 16 || D > 256 || D % 16 || g < 1 || H < 1 || C < 1 || start < 0 ||
      start + C > S || slot < 0 || slot >= B || nsplit < 1 || nsplit > kMaxChunkSplit || rb > 65535 ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)) ||
      (quantized && (blk < 16 || blk % 16 || D % blk)))
    return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k, a.v = v;
  a.k_scale = static_cast<const __half*>(ks), a.v_scale = static_cast<const __half*>(vs);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer, a.B = B, a.H = H, a.S = S, a.D = D, a.blk = quantized ? blk : D;
  a.g = g, a.slot = slot, a.start = start, a.C = C, a.nsplit = nsplit;
  a.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(nsplit, H, static_cast<unsigned>(rb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantized ? launch_chunk<true>(a, grid, st)
                                    : launch_chunk<false>(a, grid, st);
  return static_cast<int>(err);
}

// *per_sm = the CTAs of B3 one SM of the current device holds at once for
// head_dim D and scale block blk (the instantiation and shared memory
// ift_chunk_attention launches); the wrapper splits key walks by it
int ift_chunk_ctas_per_sm(int D, int blk, int quantized, int* per_sm) {
  if (D < 16 || D > 256 || D % 16 || per_sm == nullptr ||
      (quantized && (blk < 16 || blk % 16 || D % blk)))
    return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs a{};
  a.D = D, a.blk = quantized ? blk : D;
  const cudaError_t err = quantized ? launch_chunk<true>(a, dim3(), nullptr, per_sm)
                                    : launch_chunk<false>(a, dim3(), nullptr, per_sm);
  return static_cast<int>(err);
}

}  // extern "C"
