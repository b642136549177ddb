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
// in it).
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
//       weight bit for bit.
// (The TPU kernel rounds the block scale to bf16 before the multiply; the
// port follows the codec, a difference ROADMAP section C records.)
//
// What bounds it on the H100: at decode (M <= 8) every weight byte is used
// by M rows only, so the kernel is bound by the bytes of the weight planes
// (with the metadata, per weight: 4.5 bits for the 64-row 4-bit and pair
// layouts, 5 for Q4_B32T1A/B, 6 for Q4_B32T2, 8 for Q4_B16, 8.5 for
// Q8_B32T2, 9 for Q8_B32T1).  At prefill (M in the hundreds) the
// same bytes feed M rows and the bf16 tensor-core work dominates.  B6's
// decode per byte is an integer division by a constant (a multiply-high
// and a shift) where B1 and B5 take two shifts; at M <= 8 that is integer
// work beside the same bytes.

#include "dequant_matmul.cuh"

namespace {

// The byte layouts of this file, as dequant_matmul.cuh policies (a quant
// block of 32 byte rows each, 64 K rows of a 4-bit or pair layout, 32 of
// Q8, with f16 metadata; B5's blocks of 16 to 64 K rows, f16 or f32).
using WireQ4 = Wire<64, 4, false, 0, __half>;    // B1: Q4_B64T1
using Q8Unsigned = Wire<32, 8, false, 0, __half>;  // B1: Q8_B32T1

struct Q8Signed {  // B1: Q8_B32T2, signed codes, w = q*scale (no base)
  using Meta = __half;
  static constexpr int kBlock = 32, kRows0 = 32, kRows1 = 0;
  static constexpr bool kBase = false;
  __host__ __device__ static constexpr int row(int, int k) { return k; }
  __device__ static float offset(float, float) { return 0.f; }
  __device__ static float value(uint32_t b, uint32_t, int) {
    return float(int(b ^ 0x80u) - 128);
  }
};
// B5: the i4 layout, w = n*scale + (8*scale + base), for a quant block
// of kBlock_ K rows (kBlock_/2 nibble-pair byte rows) and Meta_ block
// metadata: Q4_B64T1 (64, f16), Q4_B32T1A/B (32, f16), Q4_B32T2 (32, f32)
// and Q4_B16 (16, f32).  The f32 formats' scale and base are read as the
// codec stores them (codec_torch.dequantize's values), not as f16 bits.
template <int kBlock_, class Meta_>
struct PackedI4 {
  using Meta = Meta_;
  static constexpr int kBlock = kBlock_, kRows0 = kBlock_ / 2, kRows1 = 0;
  static constexpr bool kBase = true;
  __host__ __device__ static constexpr int row(int, int k) { return k / 2; }
  __device__ static float offset(float scale, float base) {
    return __fadd_rn(__fmul_rn(scale, 8.f), base);
  }
  __device__ static float value(uint32_t b, uint32_t, int k) {
    return float(int(((b >> (4 * (k & 1))) & 0xFu) ^ 8u) - 8);
  }
};
using I4B64 = PackedI4<64, __half>;    // Q4_B64T1
using I4B32 = PackedI4<32, __half>;    // Q4_B32T1A / B
using I4B32F32 = PackedI4<32, float>;  // Q4_B32T2
using I4B16F32 = PackedI4<16, float>;  // Q4_B16
struct Pair8 {  // B6: Q3H pair8, b = v0 + 11*v1, w = v*scale + base
  using Meta = __half;
  static constexpr int kBlock = 64, kRows0 = 32, kRows1 = 0;
  static constexpr bool kBase = true;
  __host__ __device__ static constexpr int row(int, int k) { return k / 2; }
  __device__ static float offset(float, float base) { return base; }
  __device__ static float value(uint32_t b, uint32_t, int k) {
    const uint32_t v1 = b / 11u;
    return float((k & 1) ? v1 : b - 11u * v1);
  }
};

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// plan_matmul (dequant_matmul.cuh) for ift_q4_matmul / ift_q8_matmul /
// ift_q8u_matmul / the ift_i4*_matmul entries / ift_q3h_matmul (IFT_MATMUL_ENTRY's
// signature; these one-plane layouts do not read `data_h`).
int ift_matmul_plan(int M, int K, int N, int block, int sm_count,
                    int* kb_per_split, int* ksplit) {
  return plan_matmul(M, K, N, block, sm_count, kb_per_split, ksplit);
}

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

}  // extern "C"
