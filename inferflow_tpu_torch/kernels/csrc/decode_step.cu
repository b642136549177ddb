// Whole-model fused decode step (B4) for int8 per-column ("i8mm") weights,
// for the i4 layout's packed nibbles ("i4x8" and "i4bf16") and for the Q8
// block formats ("byte"), with a Q8 KV cache, plus the GEMVs it is built
// from.
//
// Replaces inferflow_tpu/kernels/decode_step.py `_make_kernel` (its
// pallas_call at :1373, public entry `fused_decode_step` at :1574) in its
// weight modes (a) i8mm (`_MM.percol`), (b) i4x8 (`_MM.i4x8`, the
// default under INFERFLOW_I4_DOT), (b') i4bf16 (the bf16-unpack i4 tile,
// `stream_mm` :573-583, INFERFLOW_I4_DOT set to anything but i8) and
// (c) byte-per-code (`_mm_cfg` with
// pk = 1, `stream_mm`'s single-plane branch :583-606: Q8_B32T2 and
// Q8_B32T1), and its routed-expert mode (g) (`moe_slot` :1105-1151) for
// MoE layers, with both attention modes: per-slot for
// B = 1 and batched (bf16-rounded q and p*vscale) for B > 1; over the
// dense cache or, in its paged mode (f), over the page pool of
// runtime/paged_kv.py through the page table.  Each product takes its own
// weight mode from the per-layer table.
//
// Per layer l the step computes (the TPU kernel's phases 1-8):
//   xn   = bf16(rmsnorm(xres) * anorm)        x quantized per row to int8
//   qkv  = W(xn): i8mm f32((acc_i32 * xs_row) * wscale_col), or i4x8
//          sum over quant blocks r (64, 32 or 16 rows) of
//          bf16(sum_r xn) * bf16(8*sc + base)
//          + f32(acc_i32 over r) * (xs_row * sc), or i4bf16 the same
//          fold term plus sum_{k in r} xn_k * bf16(bf16(n_k) * bf16(sc))
//          in float32 (no int8 rows), or byte: sum over
//          32-row blocks r of sum_{k in r} xn_k * bf16(q_k * bf16(sc))
//          (+ bf16(sum_r xn) * bf16(base) for Q8_B32T1), xn in bf16
//   q, k = rope(q), rope(k); the step's K/V row quantized to Q8 (f32 scale
//          for the self term, f16 scale and the codes into cache row
//          `length` of layer l)
//   ctx  = bf16(softmax over cache rows [0, length) and the self row)
//   xres += bf16(W(ctx, wo))
//   xn    = bf16(rmsnorm(xres) * fnorm); h2 = W(xn, w1n3) (f32)
//   hglu  = bf16(act(a) * g)
//   xres += bf16(W(hglu, w2))
// as five launches per layer, issued by one C call per step that walks a
// per-layer pointer table (no Python between the launches):
//   gemv<norm prologue, f32 out>          qkv
//   step_attention                        rope, self row, cache walk
//   gemv<amax prologue, residual add>     wo
//   gemv<norm prologue, GLU epilogue>     w1n3 (a and g columns paired)
//   gemv<amax prologue, residual add>     w2
// A MoE layer (mode (g)) replaces the last two by
//   moe_route                             xn, gate dot, softmax, top-k
//   gemv<row prologue, GLU epilogue> x B  w1n3 of each chosen expert
//   gemv<amax prologue, f32 out> x B      w2 of each chosen expert
//   moe_combine                           xres += bf16(y * v_j), j in order
// where the B launches of a GEMV are one per row count m = 1..B, grid.z
// over the experts: a CTA whose expert holds m rows runs an m-row GEMV
// over them, the others exit at once.  Each chosen expert is read once
// per step for all the slots that chose it (the TPU kernel streams it
// once per (slot, expert)), and no routing crosses to the host.
//
// What bounds it on the H100: a decode step streams every weight once
// (i8mm: about 1 GB at tinyllama-1.1b, 6.9 GB at llama2-7b; i4x8: 4.5 bits
// per weight in 64-row blocks, 3.7 GB at llama2-7b, 5 to 8 bits in 32- and
// 16-row blocks; byte: 8.5 bits, 6.9 GB at llama2-7b)
// for B <= 8 rows, at most 2*B operations per weight, far below the card's
// operations per byte: it is bound by the weight bytes (and the live KV
// rows).
//
// What the design does about it:
//   - i8mm_gemv: each thread owns 4 adjacent columns and loads one 32-bit
//     word from each of 4 consecutive K rows of the (K, N) plane (a warp
//     reads 128 contiguous bytes of a row); __byte_perm transposes the four
//     words into four columns of 4 K-values, and __dp4a multiplies them by
//     the 4 activation codes of each row in int32.  K is split across the
//     8 warps of a CTA and across CTAs (about two CTAs per SM); integer sums
//     are associative, so the CTAs add their partials with atomics into a
//     zeroed int32 workspace, and the last CTA of each column tile (a
//     counter per tile) applies the scales and the epilogue and zeroes the
//     workspace again.  The result does not depend on the order;
//   - the i4x8 GEMV: one 32-bit load of a (K/2, N) nibble-pair row gives 4
//     columns x 2 K rows; two rows' nibbles, sign-extended in place to
//     int8 (sext_nibbles), are 4 K rows of 4 columns, which transpose4 and
//     __dp4a take as in the i8mm GEMV.  Each warp takes whole quant blocks
//     (all 32, 16 or 8 byte rows of a block in flight before their math) and
//     scales each block's int32 dot into a float32 sum; the block scale
//     makes the partials floats, which do not add in any order to the same
//     bits, so the warps' sums are added in warp order and the K splits'
//     partials go to a float workspace that the last CTA of the column
//     tile adds in split order: the same bits on every run.  The block's
//     K rows (64, 32 or 16) and its metadata type (f16, or f32 for Q4_B32T2
//     and Q4_B16) are template parameters, one instantiation per geometry
//     (WeightMode), so each GEMV's loop is unrolled for its block: a row
//     map read at run time slowed the dense GEMVs on the card;
//   - the i4bf16 GEMV (b'): the i4x8 GEMV's nibble loads and unrolled
//     blocks with the byte GEMV's staged bf16 activations: each nibble is
//     unpacked to bf16(bf16(n) * bf16(sc)) and multiplied by its bf16
//     activation into a float32 sum, the block's fold term
//     bf16(sum x) * bf16(8*sc + base) added once per block; its float sums
//     take the same fixed order (warps, then splits);
//   - the byte GEMV: one 32-bit load of a (K, N) code row gives 4 columns
//     of one K row, a 32-row quant block is 32 loads in flight per thread
//     (64 for the GLU's two column segments);
//     the activations stay bf16 (no row quantization: the CTA stages its
//     bf16 K slice in shared memory) and every weight is
//     bf16(q * bf16(scale)), multiplied by its activation into a float32
//     sum; Q8_B32T1's base enters once per block through the block's
//     bf16 activation sum.  Its float sums take the i4x8 GEMV's order
//     (warps, then splits): the same bits on every run;
//   - prologues: every CTA recomputes the row norm and the row max of its
//     <= 8 rows from L2 (rmsnorm), or reads the row max that the previous
//     launch accumulated with atomicMax on the float bits (ctx, hglu), then
//     quantizes only its own K slice into shared memory;
//   - the GLU epilogue pairs column j of `a` with column j of `g` in one
//     CTA, so hglu is produced without another launch;
//   - step_attention: one CTA per (slot, kv head, split of the cache rows)
//     serves the head's g query rows from one read of each cache tile
//     (B2's tile walk); the last split to finish merges the splits'
//     running max, sum and accumulator (flash-decoding), so up to B * H * 16
//     CTAs walk a long cache instead of B * H.  Each slot sizes its splits
//     on its own length, not on the cache's capacity (a 32k-row pool
//     would otherwise cut a short slot's rows into mostly empty splits);
//     a tile of 32 rows is contiguous in the dense cache and in a page, so
//     the paged mode only looks up each tile's page.
// Row quantization and the output scaling use __fdiv_rn / __fmul_rn /
// __fadd_rn (no contraction into FMA), so they equal the plain version's
// float32 arithmetic bit for bit.
// Still to do (later work): one persistent kernel or a CUDA graph for the
// step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

// ---------------------------------------------------------- the GEMVs
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kTileCols = 128;  // columns per segment: 32 lanes x 4
constexpr int kMaxKc = 1024;    // K rows per CTA (shared x staging)
constexpr int kMinKc = 64;
constexpr int kUnroll = 4;      // i8mm: 4-row groups in flight per warp
constexpr int kByteBlock = 32;  // byte mode: K rows (= byte rows) per quant block
constexpr int kMaxSlots = 8;    // rows of a GEMV, slots of a step
constexpr int kMaxExperts = 64; // mode (g): experts per MoE layer

enum Prologue { kProNorm = 0, kProRow = 1, kProAmax = 2 };
enum Epilogue { kEpiF32 = 0, kEpiResid = 1, kEpiGlu = 2 };
// kModeByte: Q8_B32T2 (signed codes, no base); kModeByteU: Q8_B32T1
// (codes 0..255 and a base); both run the byte GEMV.  The i4x8 modes, one
// per geometry of the i4 layout (its quant block's K rows and the type of
// its scale and base), each its own instantiation of the i4x8 GEMV:
// kModeI4x8 Q4_B64T1 (64, f16), kModeI4x8B32 Q4_B32T1A/B (32, f16),
// kModeI4x8B32F Q4_B32T2 (32, f32), kModeI4x8B16F Q4_B16 (16, f32); the
// (b') modes kModeI4Bf16* the same four geometries with bf16 activations,
// each its own instantiation of the i4bf16 GEMV.
enum WeightMode {
  kModeI8mm = 0, kModeI4x8 = 1, kModeByte = 2, kModeByteU = 3,
  kModeI4x8B32 = 4, kModeI4x8B32F = 5, kModeI4x8B16F = 6,
  kModeI4Bf16 = 7, kModeI4Bf16B32 = 8, kModeI4Bf16B32F = 9, kModeI4Bf16B16F = 10,
  kModeLast = kModeI4Bf16B16F
};
// the i4x8 modes (int8 activations)
__host__ __device__ constexpr bool is_i4(int mode) {
  return mode == kModeI4x8 || (mode >= kModeI4x8B32 && mode <= kModeI4x8B16F);
}
// the (b') modes (bf16 activations)
__host__ __device__ constexpr bool is_i4bf(int mode) {
  return mode >= kModeI4Bf16 && mode <= kModeI4Bf16B16F;
}
// an i4 layout mode's K rows per quant block (nibble-pair byte rows: half
// that)
__host__ __device__ constexpr int i4_block(int mode) {
  return mode == kModeI4x8 || mode == kModeI4Bf16      ? 64
         : mode == kModeI4x8B16F || mode == kModeI4Bf16B16F ? 16
                                                           : 32;
}
__host__ __device__ constexpr bool i4_f32_meta(int mode) {
  return mode == kModeI4x8B32F || mode == kModeI4x8B16F || mode == kModeI4Bf16B32F ||
         mode == kModeI4Bf16B16F;
}

struct GemvArgs {
  const __nv_bfloat16* x;      // (M, K) bf16 activations
  const __nv_bfloat16* norm_w; // (K,) rmsnorm weight (kProNorm)
  const unsigned* amax_in;     // (M,) row max |x| as float bits (kProAmax)
  const void* w;               // i8mm: (K, N) int8; i4x8, i4bf16: (K/2, N) uint8 nibble pairs;
                               // byte: (K, N) uint8 codes
  const void* w_scale;         // i8mm: (N,) f32 column scales; i4: (K/block, N) f16
                               // or f32 (the mode's); byte: (K/32, N) f16
  const void* w_base;          // i4, byte: block bases of the scales' type, or null
  float* out_f32;              // (M, N) (kEpiF32)
  __nv_bfloat16* out_bf16;     // (M, N) residual (kEpiResid), (M, ld_out) hglu (kEpiGlu)
  unsigned* amax_out;          // (M,) row max |hglu| (kEpiGlu)
  int* ws;                     // i8mm: (M, N) int32, zero on entry and on exit
  float* part;                 // i4, byte: (ksplit, M, N) float split partials
  int* counters;               // (column tiles,), zero on entry and on exit
  int M, K, N, kc, ksplit, ld_out;
  int pro, epi, act;           // act: 0 silu, 1 gelu (tanh form), 2 relu
  int byte_signed;             // byte: Q8_B32T2's signed codes (else 0..255)
  float eps;
  // mode (g), routed experts: grid.z runs over the experts, and the CTAs of
  // expert z work only when exactly M row ids chose z (one launch per M);
  // null moe_sel: the dense GEMV, rows 0..M-1
  const int* moe_sel;          // (moe_ids,) the expert of row id r = slot * top_k + j
  int moe_ids;                 // B * top_k
  int x_div;                   // the activation row of row id r: r / x_div
  int out_rows;                // rows of out, ws and part (M for the dense GEMV)
  long long w_estride, sc_estride, base_estride;  // bytes from expert z to z + 1
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The activation the GEMV quantizes: the bf16 rmsnorm output
// bf16((x * inv) * w), or x itself, of activation row xr.
__device__ __forceinline__ float activation(const GemvArgs& a, int xr, int k, float inv) {
  const float v = bf(a.x[(size_t)xr * a.K + k]);
  if (a.pro != kProNorm) return v;
  return round_bf16(__fmul_rn(__fmul_rn(v, inv), bf(a.norm_w[k])));
}

__device__ __forceinline__ float glu_act(float x, int act) {
  if (act == 2) return fmaxf(x, 0.f);
  if (act == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, __fmul_rn(x, __fmul_rn(x, x)))));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
  }
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))));
}

// 4 words (4 consecutive K rows, 4 columns each) -> 4 words (4 columns,
// 4 consecutive K values each, low byte first)
__device__ __forceinline__ void transpose4(const uint32_t r[4], int col[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// Four bytes that each hold a nibble in 0..15 -> the nibbles read as
// signed 4-bit values, sign-extended to int8 in place: a byte whose bit 3
// is set gets 0xF0 or-ed in (8 * 0x1E = 0xF0; no carry between bytes).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

// The block metadata of 4 neighbouring columns (one 8- or 16-byte load),
// as float32.
__device__ __forceinline__ void load_meta4(const __half* p, float v[4]) {
  const uint2 bits = __ldg(reinterpret_cast<const uint2*>(p));
  const __half* h = reinterpret_cast<const __half*>(&bits);
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = __half2float(h[c]);
}
__device__ __forceinline__ void load_meta4(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

// The int8 GEMV (MODE kModeI8mm: i8mm weights), the i4x8 GEMV (kModeI4x8:
// the i4 layout's nibble pairs) and the byte GEMV (kModeByte: Q8 block
// codes, signed or not by a.byte_signed), with the same prologues and
// epilogues.  grid (column tiles, ksplit).  NSEG = 2 (GLU): segment 1 is
// column tile*128 + c + N/2, the gate column paired with column
// tile*128 + c.
//
// i8mm: y = (float(sum_k xq*wq) * xs_row) * scale_col; the int32 partials
// of the warps and the splits are added with atomics (order-free).
// i4x8 (the TPU kernel's i4x8 tile, decode_step.py:537-572): per quant
// block r (64, 32 or 16 K rows, the mode's),
//   y += bf16(sum_{k in r} x_k) * bf16(8*sc + base)
//        + float(int32 sum_{k in r} xq_k * n_k) * (xs_row * sc),
// with n the signed nibble and sc, base the block's f16 or f32 metadata
// as stored (the TPU kernel decodes f32 metadata as f16 bits: ROADMAP C7).
// i4bf16 (b', the TPU kernel's bf16-unpack tile, :573-583): per quant
// block r, y += bf16(sum_{k in r} x_k) * bf16(8*sc + base)
//             + sum_{k in r} x_k * bf16(bf16(n_k) * bf16(sc)),
// with x the bf16 activations (no row quantization).
// byte (the TPU kernel's single-plane tile with pk = 1, :583-606): per
// 32-row quant block r, y += sum_{k in r} x_k * bf16(q_k * bf16(sc))
//                          (+ bf16(sum_{k in r} x_k) * bf16(base)),
// with x the bf16 activations (no row quantization) and q the code.
// i4x8, i4bf16 and byte: every warp takes whole blocks of the CTA's K slice, the
// warps' float sums are added in warp order and the splits' in split
// order (by the last CTA of the column tile), so the result is the same
// bits on every run.
template <int M, int NSEG, int MODE, bool ROUTED>
__global__ void __launch_bounds__(kGemvThreads) gemv(const GemvArgs a) {
  constexpr bool I4 = is_i4(MODE), I4BF = is_i4bf(MODE), BYTE = MODE == kModeByte;
  constexpr bool XBF = BYTE || I4BF;  // bf16 activations, no row quantization
  // the float modes' quant block (i8mm: unused)
  constexpr int kBlk = BYTE ? kByteBlock : (I4 || I4BF) ? i4_block(MODE) : 64;
  using I4Meta = std::conditional_t<i4_f32_meta(MODE), float, __half>;
  // the CTA's K slice: int8 codes (i8mm, i4x8) or bf16 activations (byte,
  // i4bf16)
  __shared__ __align__(16) unsigned char x_s[M][kMaxKc * (XBF ? 2 : 1)];
  __shared__ int red_s[M][kTileCols * NSEG];  // int32 (i8mm) or float sums
  __shared__ float xsum_s[M][kMaxKc / ((I4 || I4BF) ? kBlk : kByteBlock)];
  __shared__ float xs_s[M];
  __shared__ float inv_s[M];
  __shared__ int xrow_s[M], orow_s[M];  // activation and output row of row m
  __shared__ int last_s, nrows_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x;
  // ROUTED (mode (g)): expert z's slice of the weight stack (offsets of
  // its codes, scales and bases; 0 for the dense GEMV, folded away), its
  // set of tile counters, and row m's activation and output rows (row m
  // for both in the dense GEMV)
  const long long w_off = ROUTED ? blockIdx.z * a.w_estride : 0;
  const long long sc_off = ROUTED ? blockIdx.z * a.sc_estride : 0;
  const long long base_off = ROUTED ? blockIdx.z * a.base_estride : 0;  // bytes
  int* counters = a.counters + (ROUTED ? (size_t)blockIdx.z * gridDim.x : 0);
  auto xrow = [&](int m) -> int {
    if constexpr (ROUTED) return xrow_s[m];
    return m;
  };
  auto orow = [&](int m) -> int {
    if constexpr (ROUTED) return orow_s[m];
    return m;
  };
  if constexpr (ROUTED) {
    // this expert's row ids, ascending (by slot, then choice)
    const int z = blockIdx.z;
    if (tid == 0) {
      int n = 0;
      for (int r = 0; r < a.moe_ids; ++r)
        if (a.moe_sel[r] == z) {
          if (n < M) {
            xrow_s[n] = r / a.x_div;
            orow_s[n] = r;
          }
          ++n;
        }
      nrows_s = n;
    }
    __syncthreads();
    if (nrows_s != M) return;  // the whole CTA
  }
  const int k0 = blockIdx.y * a.kc;
  const int klen = min(a.kc, a.K - k0);
  const int ncols = a.N / NSEG;  // columns of one segment
  const int seg_stride = NSEG == 2 ? ncols : 0;
  constexpr int kCols = kTileCols * NSEG;
  float* redf = reinterpret_cast<float*>(&red_s[0][0]);

  // prologue 1: per-row norm factor and row scale, one warp per row; a
  // row of K % 8 == 0 is read as 16-byte chunks, 4 in flight per lane
  if (warp < M) {
    const int m = warp, xm = xrow(m);
    const bool vec = a.K % 8 == 0;
    const uint4* xr = reinterpret_cast<const uint4*>(a.x + (size_t)xm * a.K);
    const uint4* wr = reinterpret_cast<const uint4*>(a.norm_w);
    float inv = 1.f;
    if (a.pro == kProNorm) {
      float ss = 0.f;
      if (vec) {
#pragma unroll 4
        for (int c = lane; c < a.K / 8; c += 32) {
          const uint4 u = __ldg(xr + c);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss += bf(h[e]) * bf(h[e]);
        }
      } else {
        for (int k = lane; k < a.K; k += 32) {
          const float v = bf(a.x[(size_t)xm * a.K + k]);
          ss += v * v;
        }
      }
      ss = warp_sum(ss);
      inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)a.K), a.eps));
    }
    float amax = 0.f;
    if (XBF) {
      // no row quantization: the activations stay bf16
    } else if (a.pro == kProAmax) {
      amax = __uint_as_float(a.amax_in[xm]);
    } else if (vec) {
#pragma unroll 4
      for (int c = lane; c < a.K / 8; c += 32) {
        const uint4 u = __ldg(xr + c);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
        if (a.pro == kProNorm) {
          const uint4 wu = __ldg(wr + c);
          const __nv_bfloat16* wh = reinterpret_cast<const __nv_bfloat16*>(&wu);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            amax = fmaxf(amax, fabsf(round_bf16(__fmul_rn(__fmul_rn(bf(h[e]), inv), bf(wh[e])))));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(bf(h[e])));
        }
      }
      amax = warp_max(amax);
    } else {
      for (int k = lane; k < a.K; k += 32) amax = fmaxf(amax, fabsf(activation(a, xm, k, inv)));
      amax = warp_max(amax);
    }
    if (lane == 0) {
      inv_s[m] = inv;
      xs_s[m] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    }
  }
  for (int i = tid; i < M * kCols; i += kGemvThreads) (&red_s[0][0])[i] = 0;
  __syncthreads();

  // prologue 2: this CTA's K slice of the rows, as int8 codes or (byte,
  // i4bf16) bf16 activations; for the i4 modes, and for byte weights with
  // a base, each quant block's bf16 sum of the activations, one warp each
  for (int i = tid; i < M * klen; i += kGemvThreads) {
    const int m = i / klen, kk = i - m * klen;
    const float v = activation(a, xrow(m), k0 + kk, inv_s[m]);
    if constexpr (XBF) {
      reinterpret_cast<__nv_bfloat16*>(x_s[m])[kk] = __float2bfloat16_rn(v);  // exact
    } else {
      const float q = rintf(__fdiv_rn(v, xs_s[m]));
      reinterpret_cast<int8_t*>(x_s[m])[kk] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
    }
  }
  const int nblk = klen / kBlk;  // float modes: klen % kBlk == 0 (the plan)
  if (I4 || I4BF || (BYTE && a.w_base != nullptr)) {
    for (int p = warp; p < M * nblk; p += kGemvWarps) {
      const int m = p / nblk, lb = p - m * nblk;
      const int kb0 = k0 + lb * kBlk;
      float v = lane < kBlk ? activation(a, xrow(m), kb0 + lane, inv_s[m]) : 0.f;
      if (kBlk == 64) v = __fadd_rn(v, activation(a, xrow(m), kb0 + 32 + lane, inv_s[m]));
      v = warp_sum(v);
      if (lane == 0) xsum_s[m][lb] = round_bf16(v);
    }
  }
  __syncthreads();

  const int col0 = tile * kTileCols + lane * 4;
  const bool col_ok = col0 < ncols;  // N/NSEG % 4 == 0: all 4 columns valid
  if constexpr (MODE == kModeI8mm) {
    // int8 x int8 -> int32 over the slice
    const int8_t* w8 = static_cast<const int8_t*>(a.w) + w_off;
    int acc[M][4 * NSEG];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4 * NSEG; ++c) acc[m][c] = 0;

    const int ngroups = klen / 4;
    if (col_ok) {
      for (int g0 = warp; g0 < ngroups; g0 += kGemvWarps * kUnroll) {
        uint32_t words[kUnroll][NSEG][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gi = g0 + u * kGemvWarps;
#pragma unroll
          for (int s = 0; s < NSEG; ++s)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              words[u][s][r] = gi < ngroups
                  ? __ldg(reinterpret_cast<const uint32_t*>(
                        w8 + (size_t)(k0 + 4 * gi + r) * a.N + col0 + s * seg_stride))
                  : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gi = g0 + u * kGemvWarps;
          if (gi < ngroups) {
#pragma unroll
            for (int s = 0; s < NSEG; ++s) {
              int col[4];
              transpose4(words[u][s], col);
#pragma unroll
              for (int m = 0; m < M; ++m) {
                const int xw = reinterpret_cast<const int*>(x_s[m])[gi];
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[m][s * 4 + c] = __dp4a(col[c], xw, acc[m][s * 4 + c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int s = 0; s < NSEG; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            atomicAdd(&red_s[m][s * kTileCols + lane * 4 + c], acc[m][s * 4 + c]);
    }
    __syncthreads();
  } else {
    // per quant block, in float32: i4x8 the int32 dot of the block, scaled,
    // plus its fold term; byte the block's products and its base term;
    // each warp walks whole blocks of the slice
    const uint8_t* w4 = static_cast<const uint8_t*>(a.w) + w_off;
    const char* wsc_b = static_cast<const char*>(a.w_scale) + sc_off;
    const char* wbs_b = a.w_base == nullptr ? nullptr : static_cast<const char*>(a.w_base) + base_off;
    const __half* wsc = reinterpret_cast<const __half*>(wsc_b);
    float acc[M][4 * NSEG];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4 * NSEG; ++c) acc[m][c] = 0.f;

    if (BYTE && col_ok) {
      // q = code read as signed (Q8_B32T2) or not (Q8_B32T1), exact
      const uint32_t flip = a.byte_signed ? 0x80u : 0u;
      const float sub = a.byte_signed ? 128.f : 0.f;
      for (int lb = warp; lb < nblk; lb += kGemvWarps) {
        const int kb = k0 / kByteBlock + lb;
        // all 32 code rows of the block, of every segment, in flight at once
        uint32_t words[NSEG][kByteBlock];
        float sc[NSEG][4];
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          const int col = col0 + s * seg_stride;
#pragma unroll
          for (int r = 0; r < kByteBlock; ++r)
            words[s][r] = __ldg(reinterpret_cast<const uint32_t*>(
                w4 + ((size_t)kb * kByteBlock + r) * a.N + col));
          const uint2 sc_bits = __ldg(reinterpret_cast<const uint2*>(wsc + (size_t)kb * a.N + col));
          const __half* sch = reinterpret_cast<const __half*>(&sc_bits);
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[s][c] = round_bf16(__half2float(sch[c]));
        }
#pragma unroll
        for (int r = 0; r < kByteBlock; ++r) {
          float xr[M];
#pragma unroll
          for (int m = 0; m < M; ++m)
            xr[m] = bf(reinterpret_cast<const __nv_bfloat16*>(x_s[m])[lb * kByteBlock + r]);
#pragma unroll
          for (int s = 0; s < NSEG; ++s)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float q = float(((words[s][r] >> (8 * c)) & 0xFFu) ^ flip) - sub;
              const float w = round_bf16(__fmul_rn(q, sc[s][c]));
#pragma unroll
              for (int m = 0; m < M; ++m) acc[m][s * 4 + c] = fmaf(xr[m], w, acc[m][s * 4 + c]);
            }
        }
        if (wbs_b != nullptr) {
#pragma unroll
          for (int s = 0; s < NSEG; ++s) {
            const uint2 bs_bits = __ldg(reinterpret_cast<const uint2*>(
                reinterpret_cast<const __half*>(wbs_b) + (size_t)kb * a.N + col0 + s * seg_stride));
            const __half* bsh = reinterpret_cast<const __half*>(&bs_bits);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float bs = round_bf16(__half2float(bsh[c]));
#pragma unroll
              for (int m = 0; m < M; ++m)
                acc[m][s * 4 + c] = __fadd_rn(acc[m][s * 4 + c], __fmul_rn(xsum_s[m][lb], bs));
            }
          }
        }
      }
    }
    if constexpr (I4) {
      constexpr int kQRows = kBlk / 2;  // nibble-pair byte rows per block
      const I4Meta* isc = reinterpret_cast<const I4Meta*>(wsc_b);
      const I4Meta* ibs = reinterpret_cast<const I4Meta*>(wbs_b);
      for (int lb = warp; col_ok && lb < nblk; lb += kGemvWarps) {
        const int kb = k0 / kBlk + lb;
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          const int col = col0 + s * seg_stride;
          // all byte rows of the block in flight at once
          uint32_t words[kQRows];
#pragma unroll
          for (int r = 0; r < kQRows; ++r)
            words[r] = __ldg(reinterpret_cast<const uint32_t*>(
                w4 + ((size_t)kb * kQRows + r) * a.N + col));
          float scv[4], bsv[4] = {0.f, 0.f, 0.f, 0.f};
          load_meta4(isc + (size_t)kb * a.N + col, scv);
          if (ibs != nullptr) load_meta4(ibs + (size_t)kb * a.N + col, bsv);
          int dot[M][4];
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[m][c] = 0;
#pragma unroll
          for (int g = 0; g < kBlk / 4; ++g) {
            // K rows 4g..4g+3 of the block: low and high nibbles of byte
            // rows 2g and 2g+1
            const uint32_t rows[4] = {sext_nibbles(words[2 * g] & 0x0F0F0F0Fu),
                                      sext_nibbles((words[2 * g] >> 4) & 0x0F0F0F0Fu),
                                      sext_nibbles(words[2 * g + 1] & 0x0F0F0F0Fu),
                                      sext_nibbles((words[2 * g + 1] >> 4) & 0x0F0F0F0Fu)};
            int colv[4];
            transpose4(rows, colv);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const int xw = reinterpret_cast<const int*>(x_s[m])[lb * (kBlk / 4) + g];
#pragma unroll
              for (int c = 0; c < 4; ++c) dot[m][c] = __dp4a(colv[c], xw, dot[m][c]);
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float sc = scv[c];
            const float fold = round_bf16(__fadd_rn(__fmul_rn(sc, 8.f), bsv[c]));
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float t = __fadd_rn(__fmul_rn(xsum_s[m][lb], fold),
                                        __fmul_rn((float)dot[m][c], __fmul_rn(xs_s[m], sc)));
              acc[m][s * 4 + c] = __fadd_rn(acc[m][s * 4 + c], t);
            }
          }
        }
      }
    }
    if constexpr (I4BF) {
      // (b'): the i4x8 walk over whole blocks, each nibble unpacked to
      // bf16(bf16(n) * bf16(sc)) and multiplied by its bf16 activation.
      // One column segment at a time (not unrolled): with both in flight
      // the 64-row GLU instantiations spilled kilobytes per thread
      constexpr int kQRows = kBlk / 2;  // nibble-pair byte rows per block
      const I4Meta* isc = reinterpret_cast<const I4Meta*>(wsc_b);
      const I4Meta* ibs = reinterpret_cast<const I4Meta*>(wbs_b);
      for (int lb = warp; col_ok && lb < nblk; lb += kGemvWarps) {
        const int kb = k0 / kBlk + lb;
#pragma unroll 1
        for (int s = 0; s < NSEG; ++s) {
          const int col = col0 + s * seg_stride;
          // all byte rows of the block in flight at once
          uint32_t words[kQRows];
#pragma unroll
          for (int r = 0; r < kQRows; ++r)
            words[r] = __ldg(reinterpret_cast<const uint32_t*>(
                w4 + ((size_t)kb * kQRows + r) * a.N + col));
          float scv[4], bsv[4] = {0.f, 0.f, 0.f, 0.f}, scb[4];
          load_meta4(isc + (size_t)kb * a.N + col, scv);
          if (ibs != nullptr) load_meta4(ibs + (size_t)kb * a.N + col, bsv);
#pragma unroll
          for (int c = 0; c < 4; ++c) scb[c] = round_bf16(scv[c]);
          float dot[M][4];
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[m][c] = 0.f;
#pragma unroll
          for (int r = 0; r < kQRows; ++r) {
            // K rows 2r (low nibbles) and 2r + 1 (high nibbles): one bf16
            // pair of each activation row
            float xr[2][M];
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const __nv_bfloat162 xp =
                  reinterpret_cast<const __nv_bfloat162*>(x_s[m])[lb * kQRows + r];
              xr[0][m] = __low2float(xp);
              xr[1][m] = __high2float(xp);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int nib = static_cast<int>((words[r] >> (8 * c + 4 * h)) & 0xFu);
                const float w = round_bf16(__fmul_rn(static_cast<float>((nib ^ 8) - 8), scb[c]));
#pragma unroll
                for (int m = 0; m < M; ++m) dot[m][c] = fmaf(xr[h][m], w, dot[m][c]);
              }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float fold = round_bf16(__fadd_rn(__fmul_rn(scv[c], 8.f), bsv[c]));
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float t = __fadd_rn(__fmul_rn(xsum_s[m][lb], fold), dot[m][c]);
              // the segment index stays a constant for the register file
              if (s == 0)
                acc[m][c] = __fadd_rn(acc[m][c], t);
              else
                acc[m][(NSEG - 1) * 4 + c] = __fadd_rn(acc[m][(NSEG - 1) * 4 + c], t);
            }
          }
        }
      }
    }
    // the warps' sums, added in warp order
    for (int w = 0; w < kGemvWarps; ++w) {
      if (warp == w && col_ok) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int s = 0; s < NSEG; ++s)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float* r = &redf[m * kCols + s * kTileCols + lane * 4 + c];
              *r = __fadd_rn(*r, acc[m][s * 4 + c]);
            }
      }
      __syncthreads();
    }
  }

  // split-K: the last CTA of the tile takes the totals
  if (a.ksplit > 1) {
    for (int i = tid; i < M * kCols; i += kGemvThreads) {
      const int m = i / kCols, j = i - m * kCols;
      const int c = tile * kTileCols + (j % kTileCols);
      if (c >= ncols) continue;
      const size_t o = (size_t)orow(m) * a.N + c + (j / kTileCols) * seg_stride;
      if constexpr (MODE != kModeI8mm)
        a.part[(size_t)blockIdx.y * a.out_rows * a.N + o] = redf[i];
      else
        atomicAdd(&a.ws[o], red_s[m][j]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(&counters[tile], 1) == a.ksplit - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int i = tid; i < M * kCols; i += kGemvThreads) {
      const int m = i / kCols, j = i - m * kCols;
      const int c = tile * kTileCols + (j % kTileCols);
      if (c >= ncols) continue;
      const size_t o = (size_t)orow(m) * a.N + c + (j / kTileCols) * seg_stride;
      if constexpr (MODE != kModeI8mm) {
        float t = 0.f;  // the splits in split order
        for (int z = 0; z < a.ksplit; ++z)
          t = __fadd_rn(t, __ldcg(a.part + (size_t)z * a.out_rows * a.N + o));
        redf[i] = t;
      } else {
        red_s[m][j] = atomicExch(&a.ws[o], 0);  // and leave zeros behind
      }
    }
    if (tid == 0) counters[tile] = 0;
    __syncthreads();
  }

  // epilogue: i8mm y = (float(acc) * xs_row) * scale_col; i4x8 and byte
  // y = the sum
  for (int i = tid; i < M * kTileCols; i += kGemvThreads) {
    const int m = i / kTileCols, j = i - m * kTileCols;
    const int c = tile * kTileCols + j;
    if (c >= ncols) continue;
    float y, gt = 0.f;
    if constexpr (MODE != kModeI8mm) {
      y = redf[m * kCols + j];
      if (NSEG == 2) gt = redf[m * kCols + kTileCols + j];
    } else {
      const float* wsc = static_cast<const float*>(a.w_scale) + sc_off / 4;
      y = __fmul_rn(__fmul_rn((float)red_s[m][j], xs_s[m]), wsc[c]);
      if (NSEG == 2)
        gt = __fmul_rn(__fmul_rn((float)red_s[m][kTileCols + j], xs_s[m]), wsc[c + seg_stride]);
    }
    const int om = orow(m);
    if (a.epi == kEpiF32) {
      a.out_f32[(size_t)om * a.N + c] = y;
    } else if (a.epi == kEpiResid) {
      __nv_bfloat16* r = a.out_bf16 + (size_t)om * a.N + c;
      *r = __float2bfloat16_rn(__fadd_rn(bf(*r), round_bf16(y)));
    } else {
      const __nv_bfloat16 h = __float2bfloat16_rn(__fmul_rn(glu_act(y, a.act), gt));
      a.out_bf16[(size_t)om * a.ld_out + c] = h;
      atomicMax(&a.amax_out[om], __float_as_uint(fabsf(bf(h))));
    }
  }
}

// CTAs for about two per SM, K rows per CTA a multiple of `unit` (32:
// whole 4-row groups per warp, or whole byte-mode quant blocks; for the i4
// modes the mode's quant block: whole blocks) and at most kMaxKc.
void gemv_plan(int K, int tiles, int sm_count, int unit, int* kc, int* ksplit) {
  const int want = std::max(1, (2 * sm_count + tiles - 1) / tiles);
  int rows = (K + want - 1) / want;
  rows = (rows + unit - 1) / unit * unit;
  rows = std::min(std::max(rows, kMinKc), kMaxKc);
  *kc = rows;
  *ksplit = (K + rows - 1) / rows;
}

template <int NSEG, int MODE, bool ROUTED>
void launch_gemv_m(const GemvArgs& a, dim3 grid, cudaStream_t stream) {
  switch (a.M) {
    case 1: gemv<1, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 2: gemv<2, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 3: gemv<3, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 4: gemv<4, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 5: gemv<5, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 6: gemv<6, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    case 7: gemv<7, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
    default: gemv<8, NSEG, MODE, ROUTED><<<grid, kGemvThreads, 0, stream>>>(a); break;
  }
}

// mode (g)'s routed GEMVs take w1n3 with the GLU epilogue and w2 with a
// float32 output; the dense ones every prologue and epilogue
template <int MODE>
void launch_gemv_mode(const GemvArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.moe_sel != nullptr) {
    if (a.epi == kEpiGlu)
      launch_gemv_m<2, MODE, true>(a, grid, stream);
    else
      launch_gemv_m<1, MODE, true>(a, grid, stream);
  } else if (a.epi == kEpiGlu) {
    launch_gemv_m<2, MODE, false>(a, grid, stream);
  } else {
    launch_gemv_m<1, MODE, false>(a, grid, stream);
  }
}

// The column tiles and the plan of a GEMV, or false for a shape it does
// not take.
bool gemv_shape(const GemvArgs& a, int mode, int sm_count, int* tiles, int* kc, int* ksplit) {
  const int nseg = a.epi == kEpiGlu ? 2 : 1;
  if (mode < kModeI8mm || mode > kModeLast) return false;
  const bool i4 = is_i4(mode) || is_i4bf(mode);
  const int unit = i4 ? i4_block(mode) : 32;
  const int k_unit = i4 ? i4_block(mode) : mode == kModeI8mm ? 4 : kByteBlock;
  if (a.M < 1 || a.M > 8 || a.K <= 0 || a.K % k_unit || a.N <= 0 || a.N % (4 * nseg) ||
      sm_count <= 0)
    return false;
  *tiles = (a.N / nseg + kTileCols - 1) / kTileCols;
  gemv_plan(a.K, *tiles, sm_count, unit, kc, ksplit);
  return true;
}

// experts > 1: mode (g)'s routed GEMV over an expert stack (a.moe_sel set)
cudaError_t launch_gemv(GemvArgs a, int mode, int sm_count, cudaStream_t stream,
                        int experts = 1) {
  int tiles = 0;
  if (a.out_rows == 0) a.out_rows = a.M;
  if (!gemv_shape(a, mode, sm_count, &tiles, &a.kc, &a.ksplit) ||
      (mode != kModeI8mm && a.ksplit > 1 && a.part == nullptr) ||
      (mode == kModeByte && a.w_base != nullptr) || (mode == kModeByteU && a.w_base == nullptr) ||
      experts < 1 || (experts > 1 && a.moe_sel == nullptr) || a.out_rows < a.M)
    return cudaErrorInvalidValue;
  const dim3 grid(tiles, a.ksplit, experts);
  switch (mode) {
    case kModeI8mm: launch_gemv_mode<kModeI8mm>(a, grid, stream); break;
    case kModeI4x8: launch_gemv_mode<kModeI4x8>(a, grid, stream); break;
    case kModeI4x8B32: launch_gemv_mode<kModeI4x8B32>(a, grid, stream); break;
    case kModeI4x8B32F: launch_gemv_mode<kModeI4x8B32F>(a, grid, stream); break;
    case kModeI4x8B16F: launch_gemv_mode<kModeI4x8B16F>(a, grid, stream); break;
    case kModeI4Bf16: launch_gemv_mode<kModeI4Bf16>(a, grid, stream); break;
    case kModeI4Bf16B32: launch_gemv_mode<kModeI4Bf16B32>(a, grid, stream); break;
    case kModeI4Bf16B32F: launch_gemv_mode<kModeI4Bf16B32F>(a, grid, stream); break;
    case kModeI4Bf16B16F: launch_gemv_mode<kModeI4Bf16B16F>(a, grid, stream); break;
    default:
      a.byte_signed = mode == kModeByte;
      launch_gemv_mode<kModeByte>(a, grid, stream);
  }
  return cudaGetLastError();
}

// ------------------------------------------------ mode (g): the routing
struct RouteArgs {
  const __nv_bfloat16* x;       // (B, E) the residual stream
  const __nv_bfloat16* norm_w;  // (E,) the MoE block's pre-norm weight
  const __nv_bfloat16* gate;    // (E, n_exp) bf16
  __nv_bfloat16* xn;            // (B, E) out: bf16(rmsnorm(x) * norm_w)
  int* sel;                     // (B * top_k) out: the expert of row id r = b * top_k + j
  float* weight;                // (B * top_k) out: v_j of row id r
  int B, E, n_exp, top_k, norm_topk;
  float eps;
};

// The CTA's sum of one float per thread: each warp's lanes, then the warps
// in order (the same bits on every run).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kGemvWarps; ++w) t += red[w];
  return t;
}

// grid (B): CTA b routes slot b (the TPU kernel's moe_slot,
// decode_step.py:1105-1151): xn_b = bf16(rmsnorm(x_b) * norm_w), logits =
// f32(xn_b) . f32(gate) (thread t sums the K rows of its 8-row chunks t,
// t + 256, ..., then the CTA adds the threads' sums), softmax, top_k by
// repeated argmax (a strictly larger probability wins: ties go to the
// lower expert), v_j = p_j / (p_0 + ... + p_{k-1}) when norm_topk.  The
// expert GEMVs find their rows in sel; nothing goes through the host.
__global__ void __launch_bounds__(kGemvThreads) moe_route(const RouteArgs a) {
  __shared__ float red_s[kGemvWarps];
  __shared__ float logit_s[kMaxExperts];
  const int tid = threadIdx.x, b = blockIdx.x;
  const __nv_bfloat16* xr = a.x + (size_t)b * a.E;
  const bool vec = a.E % 8 == 0;
  const int nchunk = vec ? a.E / 8 : a.E;  // 8 K rows per chunk, or 1
  const int per = vec ? 8 : 1;
  float ss = 0.f;
  for (int c = tid; c < nchunk; c += kGemvThreads)
    for (int e = 0; e < per; ++e) {
      const float v = bf(xr[c * per + e]);
      ss += v * v;
    }
  ss = block_sum(ss, red_s);
  const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)a.E), a.eps));
  for (int e0 = 0; e0 < a.n_exp; e0 += 8) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int c = tid; c < nchunk; c += kGemvThreads)
      for (int i = 0; i < per; ++i) {
        const int k = c * per + i;
        const float v = round_bf16(__fmul_rn(__fmul_rn(bf(xr[k]), inv), bf(a.norm_w[k])));
        if (e0 == 0) a.xn[(size_t)b * a.E + k] = __float2bfloat16_rn(v);
        const __nv_bfloat16* g = a.gate + (size_t)k * a.n_exp + e0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e0 + e < a.n_exp) acc[e] = fmaf(v, bf(g[e]), acc[e]);
      }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = block_sum(acc[e], red_s);
      if (tid == 0 && e0 + e < a.n_exp) logit_s[e0 + e] = t;
    }
  }
  if (tid != 0) return;
  float* p = logit_s;
  float mx = p[0];
  for (int e = 1; e < a.n_exp; ++e) mx = fmaxf(mx, p[e]);
  float sum = 0.f;
  for (int e = 0; e < a.n_exp; ++e) {
    p[e] = expf(__fadd_rn(p[e], -mx));
    sum = __fadd_rn(sum, p[e]);
  }
  for (int e = 0; e < a.n_exp; ++e) p[e] = __fdiv_rn(p[e], sum);
  unsigned long long used = 0ull;
  float val[4], tot = 0.f;
  int idx[4];
  for (int j = 0; j < a.top_k; ++j) {
    int best = -1;
    for (int e = 0; e < a.n_exp; ++e)
      if (!((used >> e) & 1ull) && (best < 0 || p[e] > p[best])) best = e;
    used |= 1ull << best;
    idx[j] = best;
    val[j] = p[best];
    tot = __fadd_rn(tot, val[j]);
  }
  for (int j = 0; j < a.top_k; ++j) {
    a.sel[b * a.top_k + j] = idx[j];
    a.weight[b * a.top_k + j] = a.norm_topk ? __fdiv_rn(val[j], tot) : val[j];
  }
}

// xres_b = bf16(xres_b + bf16(y_r * v_r)) for r = b * top_k + j, j in
// order: the TPU kernel's per-expert residual add, in top-k order.
__global__ void __launch_bounds__(kGemvThreads) moe_combine(__nv_bfloat16* xres, const float* y,
                                                            const float* weight, int E, int top_k) {
  const int b = blockIdx.x;
  for (int c = blockIdx.y * kGemvThreads + threadIdx.x; c < E; c += gridDim.y * kGemvThreads) {
    float v = bf(xres[(size_t)b * E + c]);
    for (int j = 0; j < top_k; ++j) {
      const int r = b * top_k + j;
      v = round_bf16(__fadd_rn(v, round_bf16(__fmul_rn(y[(size_t)r * E + c], weight[r]))));
    }
    xres[(size_t)b * E + c] = __float2bfloat16_rn(v);
  }
}

bool route_ok(int B, int E, int n_exp, int top_k) {
  return B >= 1 && B <= kMaxSlots && E > 0 && n_exp >= 1 && n_exp <= kMaxExperts && top_k >= 1 &&
         top_k <= 4 && top_k <= n_exp;
}

// ------------------------------------------------------- step attention
constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kKeyTile = 32;  // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kMaxRows = 16;  // query heads per kv head
constexpr int kRowsPerWarp = kMaxRows / kAttnWarps;
constexpr int kDPerLane = kMaxD / 32;
constexpr int kMaxBlk = kMaxD / 16;  // scale blocks per row
constexpr int kMaxSplit = 16;        // cache-walk splits per (slot, head)
constexpr int kMinSplitRows = 64;
constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const float* qkv;      // (B, (Hq + 2H) * D) this layer's qkv, [Q | K | V]
  const float* cos;      // (B, D)
  const float* sin;      // (B, D)
  const int* lengths;    // (B,) cache rows per slot before this step
  int8_t* k_cache;       // (L, B, H, S, D), or the pool (L, P, H, PT, D)
  int8_t* v_cache;
  __half* k_scale;       // (L, B, H, S, D / blk), or (L, P, H, PT, D / blk)
  __half* v_scale;
  const int* page_table; // (B, MAXP) for the pool, null for the dense cache
  __nv_bfloat16* ctx;    // (B, Hq * D)
  unsigned* ctx_amax;    // (B,) row max |ctx| as float bits
  float* part;           // (B, H, nsplit, g, D + 2) per-split m, l, acc
  int* counters;         // (B, H), zero on entry and on exit
  int layer, B, H, S, D, blk, g, order, batched, nsplit;
  int pt, maxp, pages;   // the pool: tokens per page, table width, pages
  float scale;
};

// Index (in rows of D elements) of cache row t of (slot b, kv head h) in
// this layer: the dense cache's (layer, b, h, t), or the pool's (layer,
// page_table[b, t / PT], h, t % PT).  Rows t..t+31 with t % 32 == 0 are
// contiguous in both (PT % 32 == 0).
__device__ __forceinline__ size_t cache_row(const AttnArgs& a, int b, int h, int t) {
  if (a.page_table != nullptr) {
    const int pid = a.page_table[b * a.maxp + t / a.pt];
    return (((size_t)a.layer * a.pages + pid) * a.H + h) * a.pt + t % a.pt;
  }
  return (((size_t)a.layer * a.B + b) * a.H + h) * a.S + t;
}

// grid (B, H, nsplit): slot b, kv head h, its g query rows.  The walk of
// the slot's cache rows is cut by its own length into splits of `chunk`
// rows (a multiple of 32, at least kMinSplitRows), at most nsplit of them;
// split z walks rows [z * chunk, (z + 1) * chunk) and CTAs past the last
// split return at once.  Each split leaves its running max, sum and
// accumulator in `part`; the last split of (b, h) to finish (a counter)
// merges them, adds the self row and writes ctx and the step's K/V row.
// The splits depend on the length alone, so a dense and a paged cache
// holding the same rows give the same result bit for bit.
__global__ void __launch_bounds__(kAttnThreads) step_attention(const AttnArgs a) {
  __shared__ float q_s[kMaxRows][kMaxD];
  __shared__ float kc_s[kKeyTile][kMaxD + 1];  // codes (scratch before the walk)
  __shared__ float vc_s[kKeyTile][kMaxD + 1];
  __shared__ float ksc_s[kKeyTile][kMaxBlk];
  __shared__ float vsc_s[kKeyTile][kMaxBlk];
  __shared__ float ps[kAttnWarps][kKeyTile];
  __shared__ float kself_s[kMaxD], vself_s[kMaxD];
  __shared__ int8_t kcode_s[kMaxD], vcode_s[kMaxD];
  __shared__ float bsc_s[2][kMaxBlk];
  __shared__ float sself_s[kMaxRows];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int D = a.D, g = a.g, H = a.H, hq = H * g;
  const int nblk = D / a.blk;
  const int half = D / 2;
  const int len = a.lengths[b];
  const int n_keys = min(max(len, 0), a.S);
  const int want = (n_keys + a.nsplit - 1) / a.nsplit;
  const int chunk = (max(want, kMinSplitRows) + kKeyTile - 1) / kKeyTile * kKeyTile;
  const int nsplit = max(1, (n_keys + chunk - 1) / chunk);
  if (z >= nsplit) return;
  const size_t row_q = (size_t)b * (hq + 2 * H) * D;
  const float* cs = a.cos + (size_t)b * D;
  const float* sn = a.sin + (size_t)b * D;
  float* qraw = &kc_s[0][0];  // scratch: raw q rows, then raw k and v rows
  float* kraw = &vc_s[0][0];

  for (int i = tid; i < g * D; i += kAttnThreads)
    qraw[i] = a.qkv[row_q + (size_t)h * g * D + i];
  for (int j = tid; j < D; j += kAttnThreads) {
    kraw[j] = a.qkv[row_q + (size_t)hq * D + h * D + j];
    kraw[kMaxD + j] = a.qkv[row_q + (size_t)(hq + H) * D + h * D + j];
  }
  __syncthreads();

  // rope(x) = x * cos + rot(x) * sin; rot is the half split (order 2) or
  // the interleaved pairs (order 1)
  auto rot = [&](const float* x, int j) -> float {
    if (a.order == 2) return j < half ? -x[j + half] : x[j - half];
    return (j % 2 == 0) ? -x[j + 1] : x[j - 1];
  };
  for (int i = tid; i < g * D; i += kAttnThreads) {
    const int r = i / D, j = i - r * D;
    const float* x = qraw + r * D;
    q_s[r][j] = __fadd_rn(__fmul_rn(x[j], cs[j]), __fmul_rn(rot(x, j), sn[j]));
  }
  for (int j = tid; j < D; j += kAttnThreads) {
    kself_s[j] = __fadd_rn(__fmul_rn(kraw[j], cs[j]), __fmul_rn(rot(kraw, j), sn[j]));
    vself_s[j] = kraw[kMaxD + j];
  }
  __syncthreads();

  // the step's own K/V row, quantized per block as the cache codec does;
  // the self term uses the f32 scale, the cache gets the f16 one
  if (tid < 2 * nblk) {
    const int which = tid / nblk, c = tid - which * nblk;
    const float* row = which == 0 ? kself_s : vself_s;
    float amax = 0.f;
    for (int j = c * a.blk; j < (c + 1) * a.blk; ++j) amax = fmaxf(amax, fabsf(row[j]));
    bsc_s[which][c] = __fdiv_rn(amax, 127.f);
  }
  __syncthreads();
  for (int i = tid; i < 2 * D; i += kAttnThreads) {
    const int which = i / D, j = i - which * D;
    float* row = which == 0 ? kself_s : vself_s;
    const float sc = bsc_s[which][j / a.blk];
    const float inv = sc >= 1e-5f ? __fdiv_rn(1.f, sc) : 0.f;
    const float q = fminf(fmaxf(rintf(__fmul_rn(row[j], inv)), -128.f), 127.f);
    (which == 0 ? kcode_s : vcode_s)[j] = static_cast<int8_t>(q);
    row[j] = __fmul_rn(q, sc);
  }
  __syncthreads();

  // self score (f32 q), then the q the cache scores use: bf16-rounded in
  // the batched mode, as the TPU kernel's batched dots take it
  for (int r = warp; r < g; r += kAttnWarps) {
    float s = 0.f;
    for (int j = lane; j < D; j += 32) s += q_s[r][j] * kself_s[j];
    s = warp_sum(s);
    if (lane == 0) sself_s[r] = __fmul_rn(s, a.scale);
  }
  __syncthreads();
  if (a.batched)
    for (int i = tid; i < g * D; i += kAttnThreads) q_s[i / D][i % D] = round_bf16(q_s[i / D][i % D]);

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPerLane; ++dd) acc[rr][dd] = 0.f;
  }

  const int k_end = min(n_keys, (z + 1) * chunk);
  for (int t0 = z * chunk; t0 < k_end; t0 += kKeyTile) {
    const int nt = min(kKeyTile, k_end - t0);
    const size_t row0 = cache_row(a, b, h, t0);
    const int8_t* k_rows = a.k_cache + row0 * D;
    const int8_t* v_rows = a.v_cache + row0 * D;
    const __half* k_sc = a.k_scale + row0 * nblk;
    const __half* v_sc = a.v_scale + row0 * nblk;
    __syncthreads();  // the previous tile (or the scratch) is consumed
    for (int ch = tid; ch < kKeyTile * D / 16; ch += kAttnThreads) {
      const int e0 = ch * 16, j = e0 / D, d0 = e0 - j * D;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (j < nt) {
        kw = __ldg(reinterpret_cast<const uint4*>(k_rows + (size_t)j * D + d0));
        vw = __ldg(reinterpret_cast<const uint4*>(v_rows + (size_t)j * D + d0));
      }
      const int8_t* kq = reinterpret_cast<const int8_t*>(&kw);
      const int8_t* vq = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        kc_s[j][d0 + e] = float(kq[e]);
        vc_s[j][d0 + e] = float(vq[e]);
      }
    }
    for (int i = tid; i < kKeyTile * nblk; i += kAttnThreads) {
      const int j = i / nblk, c = i - j * nblk;
      const bool ok = j < nt;
      ksc_s[j][c] = ok ? __half2float(k_sc[(size_t)j * nblk + c]) : 0.f;
      vsc_s[j][c] = ok ? __half2float(v_sc[(size_t)j * nblk + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int i = warp + rr * kAttnWarps;
      if (i < g) {  // warp-uniform
        float s = kNegInf;
        if (lane < nt) {
          // sum over scale blocks of (q . codes) * scale, then * kq scale
          s = 0.f;
          for (int c = 0; c < nblk; ++c) {
            float part = 0.f;
            for (int d = c * a.blk; d < (c + 1) * a.blk; ++d) part = fmaf(q_s[i][d], kc_s[lane][d], part);
            s = __fadd_rn(s, __fmul_rn(part, ksc_s[lane][c]));
          }
          s = __fmul_rn(s, a.scale);
        }
        const float m_new = fmaxf(m_r[rr], warp_max(s));
        const float alpha = expf(m_r[rr] - m_new);
        const float p = expf(s - m_new);  // 0 for keys past nt
        l_r[rr] = l_r[rr] * alpha + warp_sum(p);
        m_r[rr] = m_new;
        ps[warp][lane] = p;
        __syncwarp();
#pragma unroll
        for (int dd = 0; dd < kDPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (d < D) {
            const int c = d / a.blk;
            float v = 0.f;
            for (int j = 0; j < nt; ++j) {
              float pv = __fmul_rn(ps[warp][j], vsc_s[j][c]);
              if (a.batched) pv = round_bf16(pv);
              v = fmaf(pv, vc_s[j][d], v);
            }
            acc[rr][dd] = acc[rr][dd] * alpha + v;
          }
        }
        __syncwarp();
      }
    }
  }

  // this split's running max, sum and accumulator
  const size_t part_row = (size_t)(b * H + h) * a.nsplit;
  const int stride = D + 2;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = warp + rr * kAttnWarps;
    if (i < g) {
      float* pr = a.part + ((part_row + z) * g + i) * stride;
      if (lane == 0) {
        pr[0] = m_r[rr];
        pr[1] = l_r[rr];
      }
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) pr[2 + d] = acc[rr][dd];
      }
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last_s;
  if (tid == 0) last_s = atomicAdd(&a.counters[b * H + h], 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last split: merge the splits, then the self term, ctx and its
  // row max
  float amax = 0.f;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = warp + rr * kAttnWarps;
    if (i < g) {
      float m = kNegInf;
      for (int zz = 0; zz < nsplit; ++zz)
        m = fmaxf(m, __ldcg(a.part + ((part_row + zz) * g + i) * stride));
      float l = 0.f, o[kDPerLane];
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) o[dd] = 0.f;
      for (int zz = 0; zz < nsplit; ++zz) {
        const float* pr = a.part + ((part_row + zz) * g + i) * stride;
        const float w = expf(__ldcg(pr) - m);
        l += w * __ldcg(pr + 1);
#pragma unroll
        for (int dd = 0; dd < kDPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (d < D) o[dd] += w * __ldcg(pr + 2 + d);
        }
      }
      const float s_self = sself_s[i];
      const float m_new = fmaxf(m, s_self);
      const float alpha = expf(m - m_new);
      const float p_self = expf(s_self - m_new);
      const float inv = 1.f / fmaxf(l * alpha + p_self, 1e-30f);
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) {
          const __nv_bfloat16 out =
              __float2bfloat16_rn((o[dd] * alpha + p_self * vself_s[d]) * inv);
          a.ctx[(size_t)b * hq * D + (size_t)(h * g + i) * D + d] = out;
          amax = fmaxf(amax, fabsf(bf(out)));
        }
      }
    }
  }
  amax = warp_max(amax);
  if (lane == 0) atomicMax(&a.ctx_amax[b], __float_as_uint(amax));
  if (tid == 0) a.counters[b * H + h] = 0;

  // the step's K/V row into cache row `length` of this layer (clamped to
  // S - 1; through the page table for the pool, where an inactive slot's
  // zeroed row sends it to the page-0 sentinel); written after every
  // split's walk, which never reads it when length < S
  const size_t row = cache_row(a, b, h, min(max(len, 0), a.S - 1));
  for (int j = tid; j < D; j += kAttnThreads) {
    a.k_cache[row * D + j] = kcode_s[j];
    a.v_cache[row * D + j] = vcode_s[j];
  }
  for (int c = tid; c < nblk; c += kAttnThreads) {
    a.k_scale[row * nblk + c] = __float2half_rn(bsc_s[0][c]);
    a.v_scale[row * nblk + c] = __float2half_rn(bsc_s[1][c]);
  }
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The K splits of a GEMV of (K, N) weights (N the w1n3 width when glu is
// set) in weight mode `mode` (WeightMode: 0 i8mm, 1 i4x8 Q4_B64T1, 2 byte
// Q8_B32T2, 3 byte Q8_B32T1, 4-6 i4x8 Q4_B32T1A/B, Q4_B32T2, Q4_B16, 7-10
// i4bf16 Q4_B64T1, Q4_B32T1A/B, Q4_B32T2, Q4_B16) on a card of `sm_count`
// SMs, or -1 for a shape it does not take: the i4 and byte GEMVs' float
// split partials take ksplit * M * N floats.
int ift_gemv_splits(int K, int N, int glu, int mode, int sm_count) {
  GemvArgs a{};
  a.M = 1, a.K = K, a.N = N, a.epi = glu ? kEpiGlu : kEpiF32;
  int tiles = 0, kc = 0, ksplit = 0;
  return gemv_shape(a, mode, sm_count, &tiles, &kc, &ksplit) ? ksplit : -1;
}

// y (M, N) f32 = (int8 rows of x (M, K) bf16) x (K, N) int8, scaled by the
// row and column scales.  ws (M*N int32) and counters (ceil(N/128) int32)
// are zero on entry and are left zero.
int ift_i8mm_gemv(const void* x, const void* w, const void* w_scale, void* out,
                  void* ws, void* counters, int M, int K, int N, int sm_count,
                  void* stream) {
  GemvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.w_scale = w_scale;
  a.out_f32 = static_cast<float*>(out);
  a.ws = static_cast<int*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M, a.K = K, a.N = N;
  a.pro = kProRow, a.epi = kEpiF32;
  return static_cast<int>(
      launch_gemv(a, kModeI8mm, sm_count, static_cast<cudaStream_t>(stream)));
}

// y (M, N) f32 = the i4x8 product of x (M, K) bf16 with the i4 layout's
// data_i4p (K/2, N) uint8 and its block scale and base (K/block, N; base
// may be null) in i4x8 mode `mode` (1, 4, 5 or 6: the block and the
// metadata type).  part holds ift_gemv_splits(K, N, 0, mode, sm_count) *
// M * N floats; counters (ceil(N/128) int32) are zero on entry and left
// zero.
int ift_i4x8_gemv(const void* x, const void* w, const void* w_scale, const void* w_base,
                  void* out, void* part, void* counters, int M, int K, int N, int mode,
                  int sm_count, void* stream) {
  if (!is_i4(mode)) return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.w_scale = w_scale;
  a.w_base = w_base;
  a.out_f32 = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.M = M, a.K = K, a.N = N;
  a.pro = kProRow, a.epi = kEpiF32;
  return static_cast<int>(
      launch_gemv(a, mode, sm_count, static_cast<cudaStream_t>(stream)));
}

// y (M, N) f32 = the (b') product of x (M, K) bf16 (no row quantization)
// with the i4 layout's data_i4p (K/2, N) uint8 and its block scale and
// base (K/block, N; base may be null) in i4bf16 mode `mode` (7-10: the
// block and the metadata type).  part and counters as for ift_i4x8_gemv.
int ift_i4bf16_gemv(const void* x, const void* w, const void* w_scale, const void* w_base,
                    void* out, void* part, void* counters, int M, int K, int N, int mode,
                    int sm_count, void* stream) {
  if (!is_i4bf(mode)) return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.w_scale = w_scale;
  a.w_base = w_base;
  a.out_f32 = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.M = M, a.K = K, a.N = N;
  a.pro = kProRow, a.epi = kEpiF32;
  return static_cast<int>(
      launch_gemv(a, mode, sm_count, static_cast<cudaStream_t>(stream)));
}

// Mode (g)'s routing launch alone: xn (B, E) bf16, then per slot its
// experts sel (B, top_k) int32 and weights (B, top_k) f32.
int ift_moe_route(const void* x, const void* norm_w, const void* gate, void* xn, void* sel,
                  void* weight, int B, int E, int n_exp, int top_k, int norm_topk, float eps,
                  void* stream) {
  if (!route_ok(B, E, n_exp, top_k)) return static_cast<int>(cudaErrorInvalidValue);
  RouteArgs ra{};
  ra.x = static_cast<const __nv_bfloat16*>(x);
  ra.norm_w = static_cast<const __nv_bfloat16*>(norm_w);
  ra.gate = static_cast<const __nv_bfloat16*>(gate);
  ra.xn = static_cast<__nv_bfloat16*>(xn);
  ra.sel = static_cast<int*>(sel);
  ra.weight = static_cast<float*>(weight);
  ra.B = B, ra.E = E, ra.n_exp = n_exp, ra.top_k = top_k, ra.norm_topk = norm_topk;
  ra.eps = eps;
  moe_route<<<B, kGemvThreads, 0, static_cast<cudaStream_t>(stream)>>>(ra);
  return static_cast<int>(cudaGetLastError());
}

// One decode step over all L layers.  `table` (host memory) holds, per
// layer, kTableStride entries: anorm, fnorm (E bf16 device pointers), then
// for each of qkv (E, (Hq+2H)D), wo (HqD, E), w1n3 (E, 2F) and w2 (F, E)
// five entries: its weight mode (WeightMode: 0 i8mm, 1 i4x8 Q4_B64T1, 2
// byte Q8_B32T2, 3 byte Q8_B32T1, 4-6 i4x8 Q4_B32T1A/B, Q4_B32T2, Q4_B16,
// 7-10 i4bf16 in the same four geometries)
// and its stored K as integers, then three device pointers, (int8 codes,
// f32 column scales, null) for i8mm, (data_i4p nibble pairs, block scales
// and block bases or null, f16 or f32 as the mode says) for i4x8 and
// i4bf16, (uint8 codes,
// f16 block scales, null) for Q8_B32T2 and (uint8 codes, f16 block
// scales, f16 block bases) for Q8_B32T1; then the MoE gate (E, n_exp)
// bf16 or null, and the bytes from one expert to the next of w1n3's codes,
// scales and bases and of w2's (a MoE layer's w1n3 and w2 point at expert
// 0 of (n_exp, K, N) stacks).  The stored K of qkv and w1n3 is E, of wo HqD;
// w2's may exceed F (zero-scale pad blocks) and is hglu's row length.
// A layer with a gate runs mode (g): the routing launch, then per row
// count m = 1..B the w1n3 and the w2 GEMV over the experts holding m rows
// (grid.z = n_exp), then the combine; the FFN rows are the B * top_k
// (slot, choice) pairs: hglu holds that many rows; moe_f32 holds each
// layer's weights (L, B * top_k) and then the expert outputs (B * top_k,
// E); route holds each layer's experts (L, B * top_k) int32 (they stay
// there after the step); amax holds L * (2B + B * top_k) row maxima.
// xres (B, E) bf16 is updated in place; every layer's K/V row is written
// into cache row lengths[b].  The cache is the dense (L, B, H, S, D) one
// when page_table is null, else the pool (L, pages, H, PT, D) with
// page_table (B, MAXP) on the device and S = MAXP * PT.  Scratch: qkv
// (B, (Hq+2H)D) f32, ctx (B, HqD) bf16, hglu (B, w2's stored K) bf16 whose
// columns past F are zero; ws, counters and amax (L*2*B) are zero on entry
// (ws and counters are left zero); gemv_part holds the i4 and byte GEMVs'
// split partials (the most ift_gemv_splits(...) * B * N of the step's
// float-mode products).  attn_part holds B * H * 16 * (Hq / H) * (D + 2) floats;
// attn_counters (B * H int32) is zero on entry and is left zero.  counters
// hold a set of column tiles per expert in mode (g).
constexpr int kTableStride = 29;

int ift_fused_decode_step(const void* const* table, int L, void* xres, const void* lengths,
                          const void* cos, const void* sin, void* k_cache, void* v_cache,
                          void* k_scale, void* v_scale, const void* page_table, void* qkv_buf,
                          void* ctx_buf, void* hglu_buf, void* ws, void* gemv_part,
                          void* counters, void* amax, void* attn_part, void* attn_counters,
                          void* moe_xn, void* moe_route_buf, void* moe_f32, int B, int E, int Hq,
                          int H, int D, int S, int blk, int F, int order, int act, int PT,
                          int MAXP, int pages, int n_exp, int top_k, int norm_topk, float eps,
                          float scale, int sm_count, void* stream_ptr) {
  if (B < 1 || B > 8 || H <= 0 || Hq % H || Hq / H > kMaxRows || D > kMaxD || D % 16 ||
      blk <= 0 || D % blk || D / blk > kMaxBlk || (order != 1 && order != 2) || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_exp != 0 && !route_ok(B, E, n_exp, top_k)) return static_cast<int>(cudaErrorInvalidValue);
  const int rk = B * top_k;  // mode (g): FFN rows, one per (slot, choice)
  int* route_i = static_cast<int*>(moe_route_buf);
  float* moe_w = static_cast<float*>(moe_f32);
  if (page_table != nullptr &&
      (PT < kKeyTile || PT % kKeyTile || MAXP < 1 || pages < 1 || S != MAXP * PT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int qdim = Hq * D, nqkv = (Hq + 2 * H) * D;
  // at most this many splits of the cache walk per (slot, kv head); each
  // slot takes as many of them as its own length needs (step_attention)
  const int nsplit = std::min(kMaxSplit, std::max(1, S / kMinSplitRows));
  auto* x = static_cast<__nv_bfloat16*>(xres);
  auto* amax_u = static_cast<unsigned*>(amax);
  for (int l = 0; l < L; ++l) {
    const void* const* p = table + (size_t)l * kTableStride;
    unsigned* ctx_amax = amax_u + (size_t)(2 * l) * B;
    unsigned* glu_amax = amax_u + (size_t)(2 * l + 1) * B;
    const void* gate = p[22];
    if ((gate != nullptr) != (n_exp != 0)) return static_cast<int>(cudaErrorInvalidValue);
    GemvArgs g{};
    g.ws = static_cast<int*>(ws);
    g.part = static_cast<float*>(gemv_part);
    g.counters = static_cast<int*>(counters);
    g.M = B;
    g.eps = eps;
    g.act = act;
    int mode[4], ks[4];
    for (int i = 0; i < 4; ++i) {
      mode[i] = static_cast<int>(reinterpret_cast<intptr_t>(p[2 + 5 * i]));
      ks[i] = static_cast<int>(reinterpret_cast<intptr_t>(p[3 + 5 * i]));
    }
    if (ks[0] != E || ks[1] != qdim || ks[2] != E || ks[3] < F)
      return static_cast<int>(cudaErrorInvalidValue);
    auto use = [&](int i) {
      g.K = ks[i];
      g.w = p[4 + 5 * i], g.w_scale = p[5 + 5 * i];
      g.w_base = p[6 + 5 * i];
    };

    // qkv = W(rmsnorm(xres) * anorm)
    use(0);
    g.x = x, g.norm_w = static_cast<const __nv_bfloat16*>(p[0]);
    g.out_f32 = static_cast<float*>(qkv_buf);
    g.N = nqkv, g.pro = kProNorm, g.epi = kEpiF32;
    cudaError_t err = launch_gemv(g, mode[0], sm_count, stream);
    if (err != cudaSuccess) return static_cast<int>(err);

    AttnArgs at{};
    at.qkv = static_cast<const float*>(qkv_buf);
    at.cos = static_cast<const float*>(cos), at.sin = static_cast<const float*>(sin);
    at.lengths = static_cast<const int*>(lengths);
    at.k_cache = static_cast<int8_t*>(k_cache), at.v_cache = static_cast<int8_t*>(v_cache);
    at.k_scale = static_cast<__half*>(k_scale), at.v_scale = static_cast<__half*>(v_scale);
    at.page_table = static_cast<const int*>(page_table);
    at.pt = PT, at.maxp = MAXP, at.pages = pages;
    at.ctx = static_cast<__nv_bfloat16*>(ctx_buf), at.ctx_amax = ctx_amax;
    at.layer = l, at.B = B, at.H = H, at.S = S, at.D = D, at.blk = blk, at.g = Hq / H;
    at.order = order, at.batched = B > 1, at.scale = scale;
    at.part = static_cast<float*>(attn_part);
    at.counters = static_cast<int*>(attn_counters);
    at.nsplit = nsplit;
    step_attention<<<dim3(B, H, nsplit), kAttnThreads, 0, stream>>>(at);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    // xres += bf16(W(ctx, wo))
    use(1);
    g.x = static_cast<const __nv_bfloat16*>(ctx_buf), g.amax_in = ctx_amax;
    g.out_bf16 = x;
    g.N = E, g.pro = kProAmax, g.epi = kEpiResid;
    if ((err = launch_gemv(g, mode[1], sm_count, stream)) != cudaSuccess) return static_cast<int>(err);

    if (gate != nullptr) {
      // mode (g): route, the experts' w1n3 + GLU and w2 over their rows,
      // then the residual adds in top-k order
      RouteArgs ra{};
      ra.x = x, ra.norm_w = static_cast<const __nv_bfloat16*>(p[1]);
      ra.gate = static_cast<const __nv_bfloat16*>(gate);
      ra.xn = static_cast<__nv_bfloat16*>(moe_xn);
      ra.sel = route_i + (size_t)l * rk;
      ra.weight = moe_w + (size_t)l * rk;
      float* y_moe = moe_w + (size_t)L * rk;
      ra.B = B, ra.E = E, ra.n_exp = n_exp, ra.top_k = top_k, ra.norm_topk = norm_topk;
      ra.eps = eps;
      moe_route<<<B, kGemvThreads, 0, stream>>>(ra);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      unsigned* moe_amax = amax_u + (size_t)2 * L * B + (size_t)l * rk;
      g.moe_sel = ra.sel, g.moe_ids = rk, g.out_rows = rk;
      auto strides = [&](int i) {
        g.w_estride = reinterpret_cast<intptr_t>(p[23 + 3 * i]);
        g.sc_estride = reinterpret_cast<intptr_t>(p[24 + 3 * i]);
        g.base_estride = reinterpret_cast<intptr_t>(p[25 + 3 * i]);
      };
      // hglu rows r = bf16(act(a) * g), (a | g) = W_e(xn_{r / top_k}, w1n3)
      use(2);
      strides(0);
      g.x = ra.xn, g.x_div = top_k;
      g.out_bf16 = static_cast<__nv_bfloat16*>(hglu_buf), g.amax_out = moe_amax;
      g.N = 2 * F, g.ld_out = ks[3], g.pro = kProRow, g.epi = kEpiGlu;
      for (int m = 1; m <= B; ++m) {
        g.M = m;
        if ((err = launch_gemv(g, mode[2], sm_count, stream, n_exp)) != cudaSuccess)
          return static_cast<int>(err);
      }
      // y rows r = W_e(hglu_r, w2), float32
      use(3);
      strides(1);
      g.x = static_cast<const __nv_bfloat16*>(hglu_buf), g.amax_in = moe_amax, g.x_div = 1;
      g.out_f32 = y_moe;
      g.N = E, g.pro = kProAmax, g.epi = kEpiF32;
      for (int m = 1; m <= B; ++m) {
        g.M = m;
        if ((err = launch_gemv(g, mode[3], sm_count, stream, n_exp)) != cudaSuccess)
          return static_cast<int>(err);
      }
      moe_combine<<<dim3(B, (E + 4 * kGemvThreads - 1) / (4 * kGemvThreads)), kGemvThreads, 0,
                    stream>>>(x, y_moe, ra.weight, E, top_k);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      continue;
    }

    // hglu = bf16(act(a) * g), (a | g) = W(rmsnorm(xres) * fnorm, w1n3);
    // rows of w2's stored K
    use(2);
    g.x = x, g.norm_w = static_cast<const __nv_bfloat16*>(p[1]);
    g.out_bf16 = static_cast<__nv_bfloat16*>(hglu_buf), g.amax_out = glu_amax;
    g.N = 2 * F, g.ld_out = ks[3], g.pro = kProNorm, g.epi = kEpiGlu;
    if ((err = launch_gemv(g, mode[2], sm_count, stream)) != cudaSuccess) return static_cast<int>(err);

    // xres += bf16(W(hglu, w2)); the zero tail of hglu meets w2's pad rows
    use(3);
    g.x = static_cast<const __nv_bfloat16*>(hglu_buf), g.amax_in = glu_amax;
    g.out_bf16 = x;
    g.N = E, g.pro = kProAmax, g.epi = kEpiResid;
    if ((err = launch_gemv(g, mode[3], sm_count, stream)) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
