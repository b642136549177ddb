// The 8-row code GEMV on Hopper's tensor cores: the pieces that X1-X4
// (unpack_exp.cu, `unpack_mma_nibble`, `unpack_mma_d`) and B4's GEMVs on
// the walk (decode_step.cu, `i4bf_walk`: the (b') modes 7-10, the wire
// modes 11-13 and pair8, mode 14; `i4x8_walk`: the i4x8 modes 1, 4-6 on
// int8 operands) share.
//
// y (M <= 8, N) = x (M, K) bf16 @ W (K, N), W dequantized from stored codes
// to bf16 in registers, is computed as y^T = W^T x^T with
// mma.sync.m16n8k16 (bf16 in, float32 sums): A is 16 output columns x 16 K
// values of dequantized weights, B is x^T (16 K x the 8 activation rows;
// rows past M are zeros), C the 16 columns x 8 rows.
//
// Fragment map (lane = 4 * g + t, g = lane / 4, t = lane % 4).  A lane
// loads 16 neighbouring columns 16g..16g+15 of its tile (one 16-byte chunk
// of a byte row) and owns exactly those columns' outputs for activation
// rows 2t and 2t+1.  Word w (columns 4w..4w+3) of a chunk feeds n-tiles
// 2w and 2w+1: byte c of the word is A row g (c even) or g + 8 (c odd) of
// n-tile 2w + c / 2.  Within a k16 step the lane takes K pairs (2t, 2t+1)
// (A registers a0, a1; B register b0) and (2t+8, 2t+9) (a2, a3; b1), in
// the natural order for every layout but Q2's (no K permutation):
//   - i4 layout (K/2, N) bytes, byte row r = K rows 2r (low nibble) and
//     2r+1 (high nibble): byte rows t and t+4 of the step, one A register
//     per byte;
//   - int8 (K, N) codes (X4): rows 2t, 2t+1, 2t+8, 2t+9 of the step, one
//     A register per column from two rows' bytes;
//   - pair8 (K/2, N) bytes, byte b = v0 + 11 * v1 with v0 K row 2r and v1
//     K row 2r+1: the i4 layout's byte order, one A register per byte;
//   - Q2 (K/4, N) bytes, 4 codes a byte, byte row r = K rows 4r..4r+3
//     (code h in bits [2h, 2h+2)): the one map that permutes K.  Lane t
//     reads byte row t of the step; its codes 0, 1 are the mma's K pair
//     (2t, 2t+1) (a0, a1) and codes 2, 3 the pair (2t+8, 2t+9) (a2, a3),
//     and the B fragments are staged in the same order (frag_word_q2).
// C register e of n-tile 2w + h holds column 4w + 2h + e / 2, row 2t + e % 2.
//
// Dequantization in bf16x2, bit for bit what the plain versions compute:
//   - nibble u of the i4 layout, value n = (u ^ 8) - 8: the bf16 bits
//     0x4300 | (u ^ 8) are 128 + (u ^ 8); minus 136 is n exactly; one
//     fma.rn.bf16x2 by the column's bf16(scale) (and -0.0) rounds the exact
//     product n * sc once: bf16(n * sc);
//   - a raw unsigned nibble u (X3, scaled after the dot): 0x4300 | u minus
//     128, exactly u; times bf16(scale) by one fma (unsigned_nibble_pair:
//     X1, the wire Q4 modes) bf16(u * sc); a 2-bit code the same way
//     (q2_pair, the wire Q2 mode);
//   - int8 code v: the float32 bits 0x4B0000uu with uu = v ^ 0x80 are
//     2^23 + v + 128; minus 2^23 + 128 is v exactly; two of them packed by
//     cvt.rn.bf16x2.f32 (exact: |v| <= 128 has 8 bits), then the same
//     multiply;
//   - a pair8 byte b: v1 = b div 11 by one multiply-high, then 0x4300 | v0
//     and 0x4300 | v1 by one multiply-add, minus 128 and the scale as for
//     a raw nibble (pair8_pair).
// The activations' B fragments come from shared memory in fragment order
// (word ((s * 32 + lane) * 2 + j) holds b_j of k16 step s; frag_word, or
// frag_word_q2 for Q2's K order), one 8-byte load per lane per step, free
// of bank conflicts.
//
// The weight bytes stream through a per-warp ring in shared memory filled
// by cp.async: each lane copies the 16-byte chunks that it alone reads, so
// only the metadata, which the four lanes of a group share, needs a
// __syncwarp.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gemv_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte chunk global -> shared: the first `valid` bytes (0..16, a
// multiple of `piece`) from src, zeros after them.  piece is 16 when src is
// 16-byte aligned, else 8 or 4 (the alignment it has); an empty piece reads
// nothing (its address is `src` itself, which the caller keeps valid).
// The memory clobber keeps loads written before a copy ahead of it: an
// activation load queued behind a warp's weight stream waits for all of it.
__device__ __forceinline__ void cp_async_chunk(void* dst, const void* src, int valid,
                                               int piece) {
  const uint32_t d = smem_addr(dst);
  if (piece == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid)
                 : "memory");
  } else if (piece == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = min(max(valid - 8 * i, 0), 8);
      const char* s = static_cast<const char*>(src) + (v > 0 ? 8 * i : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d + 8 * i), "l"(s),
                   "r"(v)
                   : "memory");
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = min(max(valid - 4 * i, 0), 4);
      const char* s = static_cast<const char*>(src) + (v > 0 ? 4 * i : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + 4 * i), "l"(s),
                   "r"(v)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest piece (16, 8 or 4 bytes) that every address base + i *
// stride + off takes: the alignment of their common bits.
__device__ __forceinline__ int piece_of(const void* base, long long stride, long long off) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(base) | static_cast<unsigned long long>(stride) |
      static_cast<unsigned long long>(off);
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : 4;
}

// word v of a chunk
__device__ __forceinline__ uint32_t chunk_word(const uint4& c, int v) {
  return v == 0 ? c.x : v == 1 ? c.y : v == 2 ? c.z : c.w;
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), float32 sums
__device__ __forceinline__ void mma(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// The int8 GEMV of B4's i4x8 modes (decode_step.cu, `i4x8_walk`) on the
// same map: c += a (16 columns x 32 K int8, row) * b (32 K x 8 rows int8,
// col), int32 sums; a0 / a1 hold A rows g / g + 8 at K 4t..4t+3, a2 / a3
// the same rows at K 16+4t..16+4t+3, b.x / b.y B column g at those K;
// C as above.
__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// The same at K 16 (m16n8k16): a0 / a1 A rows g / g + 8 at K 4t..4t+3, b B
// column g at those K.
__device__ __forceinline__ void mma_s8_k16(int c[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The signed nibbles of the i4 layout's bytes as int8 values 16 * n: a
// nibble u holds n in two's complement ((q - 8) & 0xF), so u in a byte's
// high half with zeros below is the int8 16 * n.  hi16: each byte's high
// nibble in place; lo16: its low nibble moved up.
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t lo16(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }

// round_bf16(a * b + c) per half (one rounding)
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t kOne2 = 0x3F803F80u;     // bf16x2 (1, 1)
constexpr uint32_t kM136x2 = 0xC308C308u;   // bf16x2 (-136, -136)
constexpr uint32_t kNegZero2 = 0x80008000u; // bf16x2 (-0, -0)

// two float32 values as bf16x2 (rounded to nearest even), the first in
// the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// bf16x2 of a float32 value in both halves
__device__ __forceinline__ uint32_t splat_bf16(float v) { return pack_bf16(v, v); }

// Byte C of an i4-layout word w (w4 = w >> 4): bf16x2 {bf16(n_lo * sc),
// bf16(n_hi * sc)} for its low and high nibbles, sc2 the scale in both
// halves.
template <int C>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w4, uint32_t sc2) {
  constexpr uint32_t sel = C | (C << 4) | ((C + 4) << 8) | ((C + 4) << 12);
  // bytes 0 and 2: the low and the high nibble of byte C; then the
  // mantissa of 128.0 with the nibble's bit 3 flipped: 128 + (u ^ 8)
  const uint32_t t = (__byte_perm(w, w4, sel) & 0x000F000Fu) ^ 0x43084308u;
  return fma_bf16x2(fma_bf16x2(t, kOne2, kM136x2), sc2, kNegZero2);
}

constexpr uint32_t kM128x2 = 0xC300C300u;   // bf16x2 (-128, -128)

// Byte C of a word of raw unsigned nibbles w (w4 = w >> 4), the i4
// layout's order: bf16x2 {u_lo, u_hi}, exact.  The bits 0x4300 | u are
// 128 + u; minus 128 is u, with no scale.
template <int C>
__device__ __forceinline__ uint32_t raw_nibble_pair(uint32_t w, uint32_t w4) {
  constexpr uint32_t sel = C | (C << 4) | ((C + 4) << 8) | ((C + 4) << 12);
  const uint32_t t = (__byte_perm(w, w4, sel) & 0x000F000Fu) | 0x43004300u;
  return fma_bf16x2(t, kOne2, kM128x2);
}

// Byte C of a word of unsigned nibbles w (w4 = w >> 4), the i4 layout's
// order: bf16x2 {bf16(u_lo * sc), bf16(u_hi * sc)}, sc2 the scale in both
// halves.  raw_nibble_pair's exact u, then one fma.rn.bf16x2 by the scale
// (and -0.0) rounds the exact product once.
template <int C>
__device__ __forceinline__ uint32_t unsigned_nibble_pair(uint32_t w, uint32_t w4, uint32_t sc2) {
  return fma_bf16x2(raw_nibble_pair<C>(w, w4), sc2, kNegZero2);
}

// Byte C of two 2-bit code words (Q2: 4 codes a byte, code h in bits [2h,
// 2h + 2)), a and b = a >> 2: bf16x2 {bf16(q_a * sc), bf16(q_b * sc)} of
// the lowest code of byte C of each.  With a = w >> 4 * H it is the
// codes 2H and 2H + 1 of the byte: 0x4300 | q minus 128, then the scale.
template <int C>
__device__ __forceinline__ uint32_t q2_pair(uint32_t a, uint32_t b, uint32_t sc2) {
  constexpr uint32_t sel = C | (C << 4) | ((C + 4) << 8) | ((C + 4) << 12);
  const uint32_t t = (__byte_perm(a, b, sel) & 0x00030003u) | 0x43004300u;
  return fma_bf16x2(fma_bf16x2(t, kOne2, kM128x2), sc2, kNegZero2);
}

// Column C of two int8 code words (K rows k and k+1, 4 columns each), each
// already xor-ed with 0x80808080: bf16x2 {bf16(v_k * sc), bf16(v_k+1 * sc)}.
template <int C>
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi, uint32_t sc2) {
  constexpr uint32_t sel = C | 0x7540u;  // byte C, then 0x00, 0x00, 0x4B
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.f;
  return fma_bf16x2(pack_bf16(a, b), sc2, kNegZero2);
}

// Byte C of a word of pair8 codes w (byte b = v0 + 11 * v1, the i4
// layout's order): bf16x2 {bf16(v0 * sc), bf16(v1 * sc)}.  v1 = b div 11
// is the high word of b * ceil(2^32 / 11), exact for every byte; the
// halves 0x4300 | b and 0x4300 plus v1 * (2^16 - 11) are 0x4300 | v0 and
// 0x4300 | v1 (no carry: v0 <= 10, v1 <= 23), 128 + v exactly; minus 128,
// then one fma.rn.bf16x2 by the scale (and -0.0).
template <int C>
__device__ __forceinline__ uint32_t pair8_pair(uint32_t w, uint32_t sc2) {
  const uint32_t b = __byte_perm(w, 0u, 0x4440u | C);
  const uint32_t t = __byte_perm(w, 0x43u, 0x4540u | C);  // 0x4300 | b, 0x4300
  const uint32_t v = t + __umulhi(b, 0x1745D175u) * 0xFFF5u;
  return fma_bf16x2(fma_bf16x2(v, kOne2, kM128x2), sc2, kNegZero2);
}

// A float's slot in a tile of sums with rows of `ld` floats (ld % 16 ==
// 4), column j of 128 columns: column 16g + c at 8c + g, so that the 32
// lanes adding C register e of one n-tile (columns 16g + 2q + e / 2, rows
// 2t + e % 2) touch 32 banks.
__host__ __device__ constexpr int sum_slot(int m, int j, int ld) {
  return m * ld + (j / 128) * 128 + (j % 16) * 8 + (j % 128) / 16;
}

// The 32-bit word of the B fragment buffer (uint32 view) that holds the
// bf16 pair (kk, kk + 1), kk even, of activation row m (0..7).
__device__ __forceinline__ int frag_word(int m, int kk) {
  const int s = kk / 16, w = kk % 16;
  return ((s * 32 + m * 4 + (w % 8) / 2) * 2) + w / 8;
}

// The same word for 2-bit codes (Q2, 4 codes a byte: a lane's K pairs of
// a k16 step are (4t, 4t+1) and (4t+2, 4t+3), the codes of byte row t),
// so that lane t's b0 and b1 are its 8 neighbouring bf16 values.
__device__ __forceinline__ int frag_word_q2(int m, int kk) {
  return (kk / 16) * 64 + m * 8 + (kk % 16) / 2;
}

}  // namespace gemv_mma
