// Attention over the stacked KV cache: single-token decode (B2) and the
// chunked-prefill flash attention of one slot's query chunk (B3).
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
//     rows (GQA) from one read of the K/V rows; chunked prefill takes one
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
//   Still to do (later work): split the sequence across CTAs when B*H is
//   small (decode at 4 slots runs 16 CTAs on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kMaxRows = 16;  // query rows per CTA
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kDPerLane = kMaxD / 32;
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

// A key/value tile in registers: 16-byte chunks of the contiguous rows
// t0..t0+31 of one (layer, slot, kv head), plus each chunk's scale.
constexpr int kMaxChunks = kTile * kMaxD * 2 / 16 / kThreads;

struct TileRegs {
  uint4 k[kMaxChunks], v[kMaxChunks];
  float ksc[kMaxChunks], vsc[kMaxChunks];
};

// Issue the loads of rows [t0, t0 + nt): one 16-byte load per chunk (a
// chunk never straddles a row or a scale block: D % 16 == 0, blk % 16 == 0
// or blk == D).  Rows past nt read as zeros.
template <bool QUANT>
__device__ __forceinline__ void load_tile(TileRegs& r, const uint8_t* k_rows,
                                          const uint8_t* v_rows, const __half* k_sc,
                                          const __half* v_sc, int t0, int nt, int D,
                                          int blk, int tid) {
  const int row_bytes = QUANT ? D : 2 * D;
  const int valid = nt * row_bytes / 16;
  const uint4* kt = reinterpret_cast<const uint4*>(k_rows + (size_t)t0 * row_bytes);
  const uint4* vt = reinterpret_cast<const uint4*>(v_rows + (size_t)t0 * row_bytes);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
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
template <bool QUANT>
__device__ __forceinline__ void store_tile(const TileRegs& r, float (*ks)[kMaxD + 1],
                                           float (*vs)[kMaxD + 1], int D, int tid) {
  constexpr int E = QUANT ? 16 : 8;  // elements per 16-byte chunk
  const int total = kTile * D / E;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
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

// CHUNK = false (decode): grid (B, H); rows are the g query heads of kv
//   head h of slot b = blockIdx.x, every row sees keys [0, lengths[b]).
// CHUNK = true: grid (H, ceil(C*g / kMaxRows)); row r of kv head h is
//   chunk position c = r / g, query head h*g + r % g of slot `slot`, and
//   sees keys [0, start + c + 1).
template <bool QUANT, bool CHUNK>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                 const __half* __restrict__ k_scale, const void* __restrict__ v_cache,
                 const __half* __restrict__ v_scale, const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, int layer, int B, int H, int S,
                 int D, int blk, int g, int slot, int start, int C, float scale) {
  __shared__ float qs[kMaxRows][kMaxD];
  __shared__ float ks[kTile][kMaxD + 1];
  __shared__ float vs[kTile][kMaxD + 1];
  __shared__ float ps[kWarps][kTile];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = H * g;

  int b, h, row0, n_rows, n_keys;
  if (CHUNK) {
    b = slot;
    h = blockIdx.x;
    row0 = blockIdx.y * kMaxRows;
    n_rows = min(kMaxRows, C * g - row0);
    n_keys = min(start + (row0 + n_rows - 1) / g + 1, S);
  } else {
    b = blockIdx.x;
    h = blockIdx.y;
    row0 = 0;
    n_rows = g;
    n_keys = min(max(lengths[b], 0), S);
  }

  // (B, Hq, D) for decode, (C, Hq, D) for a chunk
  auto q_offset = [&](int i) -> size_t {
    if (CHUNK) {
      const int r = row0 + i;
      return ((size_t)(r / g) * hq + h * g + r % g) * D;
    }
    return ((size_t)b * hq + h * g + i) * D;
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
  TileRegs regs;
  if (n_keys > 0)
    load_tile<QUANT>(regs, k_rows, v_rows, k_sc, v_sc, 0, min(kTile, n_keys), D, blk,
                     tid);
  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int nt = min(kTile, n_keys - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    store_tile<QUANT>(regs, ks, vs, D, tid);
    __syncthreads();
    if (t0 + kTile < n_keys)
      load_tile<QUANT>(regs, k_rows, v_rows, k_sc, v_sc, t0 + kTile,
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
        const float p = expf(s - m_new);  // 0 for masked keys: key 0 is
                                          // always visible, m_new is finite
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
}

template <bool CHUNK>
void launch(dim3 grid, bool quantized, const void* q, const void* k, const void* ks,
            const void* v, const void* vs, const void* lengths, void* out, int layer,
            int B, int H, int S, int D, int blk, int g, int slot, int start, int C,
            float scale, cudaStream_t stream) {
  auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* ksh = static_cast<const __half*>(ks);
  auto* vsh = static_cast<const __half*>(vs);
  auto* len = static_cast<const int*>(lengths);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (quantized)
    attention_kernel<true, CHUNK><<<grid, kThreads, 0, stream>>>(
        qb, k, ksh, v, vsh, len, ob, layer, B, H, S, D, blk, g, slot, start, C, scale);
  else
    attention_kernel<false, CHUNK><<<grid, kThreads, 0, stream>>>(
        qb, k, ksh, v, vsh, len, ob, layer, B, H, S, D, blk, g, slot, start, C, scale);
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D) bf16 -> out (B, Hq, D) bf16; lengths (B,) int32 on device.
int ift_decode_attention(const void* q, const void* k, const void* ks, const void* v,
                         const void* vs, const void* lengths, void* out, int layer,
                         int B, int H, int S, int D, int blk, int g, int quantized,
                         float scale, void* stream) {
  launch<false>(dim3(B, H), quantized != 0, q, k, ks, v, vs, lengths, out, layer, B, H,
                S, D, blk, g, 0, 0, 1, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// q (C, Hq, D) bf16 of slot `slot` at positions start..start+C-1 ->
// out (C, Hq, D) bf16.
int ift_chunk_attention(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, void* out, int layer, int B, int H, int S,
                        int D, int blk, int g, int slot, int start, int C, int quantized,
                        float scale, void* stream) {
  dim3 grid(H, (C * g + kMaxRows - 1) / kMaxRows);
  launch<true>(grid, quantized != 0, q, k, ks, v, vs, nullptr, out, layer, B, H, S, D,
               blk, g, slot, start, C, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
