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
// 48 KB of static shared memory (g <= 8), else 4
template <int RM>
__host__ __device__ constexpr int paged_warps() { return RM <= 8 ? 8 : 4; }

struct PagedArgs {
  const __nv_bfloat16* q;   // (B, Hq, D)
  const void* k;            // (L, P, H, PT, D) int8 or bf16
  const void* v;
  const __half* k_scale;    // (L, P, H, PT, D / 32) f16 (quantized pools)
  const __half* v_scale;
  const int* page_table;    // (B, MAXP)
  const int* lengths;       // (B,)
  float* part;              // (B, H, nsplit, g, D + 2) per-CTA m, l, acc
  int* counters;            // (B, H), zero on entry and on exit
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
template <> struct LaneWord<8> { using T = uint2; };
template <> struct LaneWord<4> { using T = unsigned int; };
template <> struct LaneWord<2> { using T = unsigned short; };
template <> struct LaneWord<1> { using T = unsigned char; };

// element i of a lane word: an int8 code or a bf16 value
template <bool QUANT, typename W>
__device__ __forceinline__ float word_elem(const W& w, int i) {
  uint32_t x;
  if constexpr (sizeof(W) == 8)
    x = i < 2 ? w.x : w.y;  // bf16 only: two values per 32-bit half
  else
    x = static_cast<uint32_t>(w);
  if constexpr (QUANT)
    return i8_byte(x, i % 4);
  else
    return bf16_half(x, i % 2);
}

// grid (B, H, nsplit).  RM >= g query rows per kv head.
template <bool QUANT, int D, int RM>
__global__ void __launch_bounds__(paged_warps<RM>() * 32)
    paged_attention_kernel(const PagedArgs a) {
  constexpr int kPagedWarps = paged_warps<RM>();
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
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int g = a.g, hq = a.H * g;
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
    q_s[i / D][i % D] = __bfloat162float(a.q[((size_t)b * hq + (size_t)h * g) * D + i]);
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
  const size_t bh = (size_t)b * a.H + h;
  float* pz = a.part + ((bh * a.nsplit + z) * g) * (size_t)stride;
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
  const float* pb = a.part + bh * a.nsplit * (size_t)g * stride;
  for (int i = tid; i < g * D; i += kPagedThreads) {
    const int r = i / D, d = i - r * D;
    float m = kNegInf;
    for (int zz = 0; zz < nsplit; ++zz) m = fmaxf(m, __ldcg(pb + ((size_t)zz * g + r) * stride));
    float l = 0.f, o = 0.f;
    for (int zz = 0; zz < nsplit; ++zz) {
      const float* pr = pb + ((size_t)zz * g + r) * stride;
      const float wt = expf(__ldcg(pr) - m);
      l += wt * __ldcg(pr + 1);
      o += wt * __ldcg(pr + 2 + d);
    }
    a.out[((size_t)b * hq + (size_t)h * g + r) * D + d] =
        __float2bfloat16_rn(o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.counters[bh] = 0;
}

template <bool QUANT, int D, int RM>
void launch_paged_rm(const PagedArgs& a, dim3 grid, cudaStream_t stream) {
  paged_attention_kernel<QUANT, D, RM><<<grid, paged_warps<RM>() * 32, 0, stream>>>(a);
}

template <bool QUANT, int D>
cudaError_t launch_paged_d(const PagedArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.g <= 1)
    launch_paged_rm<QUANT, D, 1>(a, grid, stream);
  else if (a.g <= 8)
    launch_paged_rm<QUANT, D, 8>(a, grid, stream);
  else
    launch_paged_rm<QUANT, D, 16>(a, grid, stream);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t launch_paged(const PagedArgs& a, int D, dim3 grid, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_paged_d<QUANT, 32>(a, grid, stream);
    case 64: return launch_paged_d<QUANT, 64>(a, grid, stream);
    case 128: return launch_paged_d<QUANT, 128>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D) bf16 -> out (B, Hq, D) bf16 over the page pool; page_table
// (B, MAXP) and lengths (B,) int32 on the device.  part holds
// B * H * nsplit * g * (D + 2) floats; counters (B * H int32) is zero on
// entry and is left zero.
int ift_paged_decode_attention(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* page_table, const void* lengths,
                               void* part, void* counters, void* out, int layer, int B, int H,
                               int P, int PT, int MAXP, int D, int g, int nsplit,
                               int quantized, float scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || MAXP < 1 || PT < kTile || PT % kTile || g < 1 ||
      g > kMaxRows || nsplit < 1 || nsplit > 65535)
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
  const dim3 grid(B, H, nsplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = quantized ? launch_paged<true>(a, D, grid, st)
                                    : launch_paged<false>(a, D, grid, st);
  return static_cast<int>(err);
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
