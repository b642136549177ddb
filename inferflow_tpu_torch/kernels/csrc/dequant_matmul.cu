// Dequantize-matmul for block weights stored as bytes along K:
// y = x @ dequant(W), for five byte layouts.
//
// Kernel B1 replaces inferflow_tpu/kernels/dequant_matmul.py
// `_make_fast_kernel` (its pallas_call at :505, public entry
// `quantized_matmul` at :643) for the Q4_B64T1 format in the packed wire
// layout and for the two Q8 block formats, Q8_B32T2 (the `Q8` alias and
// the q8c container) and Q8_B32T1.  Kernel B5 replaces `_make_i4_kernel`
// (:313, its pallas_call at :452) for the `i4` device layout
// (codec_jax.repack_i4) of the four 4-bit single-plane formats: Q4_B64T1,
// Q4_B32T1A/B, Q4_B32T2 and Q4_B16.  Kernel B6 replaces `_make_kernel` (:244, its
// pallas_call at :573) in its pair8 mode: Q3H_B64T1 weights in the `pair8`
// device layout (codec_torch.quantize and QuantizedTensor.from_np give Q3H
// in it); and in its wire mode: Q3H_B64T1 in its three wire planes
// (`data` 4 bits, `data_m` 2, `data_h` 1 of each pair code;
// codec_torch.from_np(..., fast_layout=False) or pair8_to_wire).  B6's
// non-pair branch needs no kernel of its own: every non-pair block format
// has a B1 entry here or in subbyte_matmul.cu whose weights are the
// branch's bit for bit (kernels/dequant_matmul.py `_launch_generic`).
//
// The kernels themselves (operands, arithmetic, the decode GEMV and the
// prefill WMMA tile) are dequant_matmul.cuh's, templated on how a block
// decodes; this file holds the byte layouts' policies and entries.  A
// byte of each layout holds the values of R K rows (R = 2 for the 4-bit
// and pair layouts, 1 for Q8), a quant block is 32 byte rows (B5: 8 to 32),
// and the metadata is f16 (B5 on Q4_B32T2 and Q4_B16: f32):
//   B1, Q4 wire planes: the low nibble is row 2r's code q in 0..15, the
//       high nibble row 2r+1's, and the weight is w = bf16(q*scale + base);
//   B1, Q8_B32T2: the byte is row r's code, a signed q in -128..127, and
//       w = bf16(q*scale) (zero base: no base pointer);
//   B1, Q8_B32T1: the byte is row r's code q in 0..255, and
//       w = bf16(q*scale + base);
//   B5, i4 layout: each nibble is (q - 8) & 0xF (the wire byte XOR 0x88),
//       read as a signed n in -8..7, and the weight is
//       w = bf16(n*scale + fold) with fold = 8*scale + base in float32, as
//       the TPU kernel folds the +8 into the block's additive term (for
//       the f32-metadata formats the TPU kernel decodes scale and base as
//       f16 bits and computes other weights; the port keeps the codec's
//       scale and base: ROADMAP C7);
//   B6, pair8: the byte is the base-11 pair code b = v0 + 11*v1, row 2r
//       takes v0 = b - 11*(b / 11) and row 2r+1 v1 = b / 11 (the TPU
//       kernel's floor((b + 0.5) / 11), exact for every byte value), and
//       the weight is w = bf16(v*scale + base), codec_torch.dequantize's
//       weight bit for bit;
//   B6, wire: pair code j of a block (K rows 2j, 2j+1) is b = data | data_m
//       << 4 | data_h << 6, its 4-, 2- and 1-bit values (consecutive
//       layout: value j in byte row j / (8/bits)), then as pair8.
// (The TPU kernel rounds the block scale to bf16 before the multiply; the
// port follows the codec, a difference ROADMAP section C records.)
//
// What bounds it on the H100: at decode (M <= 8) every weight byte is used
// by M rows only, so the kernel is bound by the bytes of the weight planes
// (with the metadata, per weight: 4.5 bits for the 64-row 4-bit and pair
// layouts, 4 for Q3H's wire planes, 5 for Q4_B32T1A/B, 6 for Q4_B32T2, 8
// for Q4_B16, 8.5 for Q8_B32T2, 9 for Q8_B32T1).  At prefill (M in the hundreds) the
// same bytes feed M rows and the bf16 tensor-core work dominates.  B6's
// decode per byte is an integer division by a constant (a multiply-high
// and a shift) where B1 and B5 take two shifts, and the wire mode first
// combines three planes' bits; at M <= 8 that is integer work beside the
// same bytes.

#include "dequant_matmul.cuh"

namespace {

// The byte layouts of this file, as dequant_matmul.cuh policies (a quant
// block of 32 byte rows each, 64 K rows of a 4-bit or pair layout, 32 of
// Q8, with f16 metadata; B5's blocks of 16 to 64 K rows, f16 or f32).
using WireQ4 = Wire<64, 4, false, 0, __half>;    // B1: Q4_B64T1
using Q8Unsigned = Wire<32, 8, false, 0, __half>;  // B1: Q8_B32T1

struct Q8Signed {  // B1: Q8_B32T2, signed codes, w = q*scale (no base)
  using Meta = __half;
  static constexpr int kBlock = 32, kRows0 = 32, kRows1 = 0, kRows2 = 0;
  static constexpr bool kBase = false, kPair = false;
  static constexpr int kBias = 128;
  __host__ __device__ static constexpr int row(int, int k) { return k; }
  __device__ static float offset(float, float) { return 0.f; }
  __device__ static float value(uint32_t b, uint32_t, uint32_t, int) {
    return float(int(b ^ 0x80u) - 128);
  }
  // b ^ 0x80 = q + 128 in every byte
  __device__ static uint32_t codes(uint32_t w, uint32_t, uint32_t, int) { return w ^ 0x80808080u; }
};
// B5: the i4 layout, w = n*scale + (8*scale + base), for a quant block
// of kBlock_ K rows (kBlock_/2 nibble-pair byte rows) and Meta_ block
// metadata: Q4_B64T1 (64, f16), Q4_B32T1A/B (32, f16), Q4_B32T2 (32, f32)
// and Q4_B16 (16, f32).  The f32 formats' scale and base are read as the
// codec stores them (codec_torch.dequantize's values), not as f16 bits.
// The tensor-core GEMV's code is the nibble XOR 8, n + 8 in 0..15 (kBias
// 8), and its offset() the fold of the plain version (i4_weight), not the
// codec's (n + 8)*scale + base.
template <int kBlock_, class Meta_>
struct PackedI4 {
  using Meta = Meta_;
  static constexpr int kBlock = kBlock_, kRows0 = kBlock_ / 2, kRows1 = 0, kRows2 = 0;
  static constexpr bool kBase = true, kPair = false;
  static constexpr int kBias = 8;
  __host__ __device__ static constexpr int row(int, int k) { return k / 2; }
  __device__ static float offset(float scale, float base) {
    return __fadd_rn(__fmul_rn(scale, 8.f), base);
  }
  __device__ static float value(uint32_t b, uint32_t, uint32_t, int k) {
    return float(int(((b >> (4 * (k & 1))) & 0xFu) ^ 8u) - 8);
  }
  __device__ static uint32_t codes(uint32_t w, uint32_t, uint32_t, int k) {
    return ((w >> (4 * (k & 1))) & 0x0F0F0F0Fu) ^ 0x08080808u;
  }
};
using I4B64 = PackedI4<64, __half>;    // Q4_B64T1
using I4B32 = PackedI4<32, __half>;    // Q4_B32T1A / B
using I4B32F32 = PackedI4<32, float>;  // Q4_B32T2
using I4B16F32 = PackedI4<16, float>;  // Q4_B16
// K row k's value from the base-11 pair code b = v0 + 11*v1 of rows 2j, 2j+1
__device__ __forceinline__ float pair_value(uint32_t b, int k) {
  const uint32_t v1 = b / 11u;
  return float((k & 1) ? v1 : b - 11u * v1);
}
struct Pair8 {  // B6: Q3H pair8, b = v0 + 11*v1, w = v*scale + base
  using Meta = __half;
  static constexpr int kBlock = 64, kRows0 = 32, kRows1 = 0, kRows2 = 0;
  static constexpr bool kBase = true, kPair = true;
  static constexpr int kBias = 0;
  __host__ __device__ static constexpr int row(int, int k) { return k / 2; }
  __device__ static float offset(float, float base) { return base; }
  __device__ static float value(uint32_t b, uint32_t, uint32_t, int k) {
    return pair_value(b, k);
  }
  __device__ static uint32_t codes(uint32_t w, uint32_t, uint32_t, int) { return w; }
};
// B6's wire mode: Q3H's 32 pair codes of a block in three planes, code j
// in plane 0's byte row j/2 (4 bits), plane 1's j/4 (2) and plane 2's j/8
// (1 bit); the code b = data | data_m << 4 | data_h << 6, then as Pair8
struct Q3HWire {
  using Meta = __half;
  static constexpr int kBlock = 64, kRows0 = 16, kRows1 = 8, kRows2 = 4;
  static constexpr bool kBase = true, kPair = true;
  static constexpr int kBias = 0;
  __host__ __device__ static constexpr int row(int p, int k) {
    return p == 0 ? k / 4 : p == 1 ? k / 8 : k / 16;
  }
  __device__ static float offset(float, float base) { return base; }
  __device__ static float value(uint32_t b0, uint32_t b1, uint32_t b2, int k) {
    const int j = k / 2;
    const uint32_t b = ((b0 >> (4 * (j & 1))) & 0xFu) | (((b1 >> (2 * (j & 3))) & 0x3u) << 4) |
                       (((b2 >> (j & 7)) & 0x1u) << 6);
    return pair_value(b, k);
  }
  // value()'s pair code in four bytes at once (4 + 2 + 1 bits, no bit
  // crosses a byte)
  __device__ static uint32_t codes(uint32_t w0, uint32_t w1, uint32_t w2, int k) {
    const int j = k / 2;
    return ((w0 >> (4 * (j & 1))) & 0x0F0F0F0Fu) | (((w1 >> (2 * (j & 3))) & 0x03030303u) << 4) |
           (((w2 >> (j & 7)) & 0x01010101u) << 6);
  }
};

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every entry is IFT_MATMUL_ENTRY's (or, for Q3H's wire planes,
// IFT_MATMUL_ENTRY3's) and has a plan, <entry>_plan; the one-plane layouts
// do not read `data_h`.
// B1: Q4_B64T1 wire planes.
IFT_MATMUL_ENTRY(ift_q4_matmul, WireQ4)
// B1: Q8_B32T2 (signed codes, no base: `base` is not read).
IFT_MATMUL_ENTRY(ift_q8_matmul, Q8Signed)
// B1: Q8_B32T1 (codes 0..255, f16 scale and base).
IFT_MATMUL_ENTRY(ift_q8u_matmul, Q8Unsigned)
// B5: the i4 layout's data_i4p plane (signed code-8 nibbles), one entry
// per block geometry: Q4_B64T1; Q4_B32T1A / B; Q4_B32T2; Q4_B16.
IFT_MATMUL_ENTRY(ift_i4_matmul, I4B64)
IFT_MATMUL_ENTRY(ift_i4b32_matmul, I4B32)
IFT_MATMUL_ENTRY(ift_i4b32f_matmul, I4B32F32)
IFT_MATMUL_ENTRY(ift_i4b16f_matmul, I4B16F32)
// B6: Q3H_B64T1 in the pair8 layout (one base-11 pair code per byte).
IFT_MATMUL_ENTRY(ift_q3h_matmul, Pair8)
// B6's wire mode: Q3H_B64T1's planes data (4 bits), data_m (2), data_h (1)
// over K/2 pair codes, f16 scale and base.
IFT_MATMUL_ENTRY3(ift_q3h_wire_matmul, Q3HWire)

}  // extern "C"
