// The dequantize-matmul kernels, y = x @ dequant(W), templated on how a
// block of W decodes; shared by dequant_matmul.cu (B1 for Q4_B64T1 and
// the Q8 formats, B5, B6 in its pair8 and wire modes) and subbyte_matmul.cu
// (B1 for the sub-byte wire formats), each of which instantiates its own
// policies.
//
// Operands (row-major):
//   x       (M, K)    bf16 activations
//   data    (K*b0/8, N) uint8: plane 0, the policy's low code bits
//   data_h  (K*b1/8, N) uint8: plane 1, the next code bits (two- and
//                      three-plane formats only; null otherwise)
//   data_2  (K*b2/8, N) uint8: plane 2, the top code bits (Q3H's wire
//                      planes only; null otherwise)
//   scale   (K/B, N)  per-block scales, f16 or f32 (the policy's Meta)
//   base    (K/B, N)  per-block bases of the same type; null for a format
//                     without one
//   out     (M, N)    bf16
// Each weight is value*scale + offset as two rounded float32 operations,
// rounded to bf16, and the products accumulate in float32: the codec's
// weights (codec_torch.dequantize), so a kernel and its plain version
// differ in summation order only.  Pad blocks of a K-padded tensor have
// scale 0 and base 0 and add exact zeros.
//
// A policy D describes a quant block of D::kBlock K rows stored in one to
// three byte planes, D::kRows0, D::kRows1 and D::kRows2 byte rows of each
// per block (0 for a plane the format lacks):
//   row(p, k)          the byte row of plane p (within the block) that holds
//                      K row k of the block;
//   value(b0, b1, b2, k)  K row k's multiplier from those bytes;
//   offset(sc, base)   the block's additive term; kBase: whether the
//                      format stores a base (read only then);
//   Meta               the type of the scale and base planes.
// Every policy also gives value() four columns at a time, for the
// tensor-core GEMV:
//   codes(w0, w1, w2, k)  from the 32-bit words of planes 0-2 that hold K
//                      row k of 4 neighbouring columns (byte j = column
//                      j), byte j of the result is column j's code, value
//                      = code - kBias; for a pair format (kPair: Q3H) the
//                      base-11 pair code of K rows k & ~1 and k | 1, value
//                      = code % 11 for the even row and code / 11 for the
//                      odd one.
//
// What the design does about the card:
//   - decode (`dq_gemv_mma`, M <= 8): the 8-row code GEMV on the tensor
//     cores of gemv_mma.cuh, below;
//   - one row on a single plane of at most 4 bits or on a split plane
//     (`dq_gemv<D, 1>`, loop_at_one_row): neighbouring threads own
//     neighbouring 4-column groups, so a warp reads 128 contiguous bytes of
//     a plane row (one 32-bit load per thread) and the block's scale/base
//     for its 128 columns; a thread loads every plane row of a quant block
//     before decoding any (memory-level parallelism); K is split over the
//     warps of a CTA and over CTAs (about two CTAs per SM, from the SM
//     count the caller reads off the device: `plan_gemv_row`), with the x
//     slice of the CTA (at most kGemvMaxKRows rows) staged once in shared
//     memory and one float32 accumulator per (row, column) in registers;
//     the split-K partial sums are added in a fixed order by a second small
//     kernel (deterministic);
//   - prefill (`dq_gemm`, every M > 8): 64x64 output tiles; per quant
//     block of K (kBK = D::kBlock rows: 64, 32 or 16) the CTA stages the x
//     tile and dequantizes the W tile into shared memory as bf16 (each
//     thread one K row of a 16-column run at a time, reading that row's
//     bytes of every plane as 16-byte loads), then runs bf16 WMMA 16x16x16
//     products with float32 accumulators.  No copy pipelining yet (later
//     work: TMA + wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gemv_mma.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// The metadata of 4 neighbouring columns (one 8- or 16-byte load).
__device__ __forceinline__ void load4(const __half* p, float v[4]) {
  const uint2 bits = *reinterpret_cast<const uint2*>(p);
  const __half* h = reinterpret_cast<const __half*>(&bits);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __half2float(h[j]);
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Wire planes (codec_torch's layout): the code of K row k is plane 0's
// kBits0-bit value OR plane 1's kBits1-bit value shifted up by kBits0, and
// the weight is code*scale + base.  A consecutive plane of b bits holds
// value k in byte row k / (8/b) at bit (k % (8/b))*b; the split-half plane
// (kSplit, 4 bits: Q5_B32T1) holds value k in byte row k % (kBlock/2), the
// low nibble for the block's first half and the high nibble for its second.
template <int kBlock_, int kBits0, bool kSplit, int kBits1, class Meta_>
struct Wire {
  static_assert(!kSplit || kBits0 == 4, "split-half planes are 4-bit");
  using Meta = Meta_;
  static constexpr int kBlock = kBlock_;
  static constexpr int kPer0 = 8 / kBits0, kPer1 = kBits1 ? 8 / kBits1 : 1;
  static constexpr int kRows0 = kBlock / kPer0;
  static constexpr int kRows1 = kBits1 ? kBlock / kPer1 : 0;
  static constexpr int kRows2 = 0;
  static constexpr bool kBase = true, kPair = false;
  static constexpr int kBias = 0;
  __host__ __device__ static constexpr int row(int p, int k) {
    return p == 0 ? (kSplit ? k % (kBlock / 2) : k / kPer0) : k / kPer1;
  }
  __device__ static float offset(float, float base) { return base; }
  __device__ static float value(uint32_t b0, uint32_t b1, uint32_t, int k) {
    const int s0 = kSplit ? (k / (kBlock / 2)) * 4 : (k % kPer0) * kBits0;
    uint32_t code = (b0 >> s0) & ((1u << kBits0) - 1u);
    if constexpr (kBits1 > 0)
      code |= ((b1 >> ((k % kPer1) * kBits1)) & ((1u << kBits1) - 1u))
              << kBits0;
    return float(code);
  }
  // value()'s shifts and masks on four bytes at once: a plane's shift plus
  // its width is at most 8 and the code fits a byte, so no bit crosses
  // into a neighbouring column
  __device__ static uint32_t codes(uint32_t w0, uint32_t w1, uint32_t, int k) {
    const int s0 = kSplit ? (k / (kBlock / 2)) * 4 : (k % kPer0) * kBits0;
    uint32_t code = (w0 >> s0) & (((1u << kBits0) - 1u) * 0x01010101u);
    if constexpr (kBits1 > 0)
      code |= ((w1 >> ((k % kPer1) * kBits1)) & (((1u << kBits1) - 1u) * 0x01010101u))
              << kBits0;
    return code;
  }
};

template <class D>
__device__ __forceinline__ float dequant(float value, float scale, float offset) {
  if constexpr (!D::kBase) return __fmul_rn(value, scale);
  return __fadd_rn(__fmul_rn(value, scale), offset);
}

// ----------------------------------------- decode on the tensor cores
// dq_gemv_mma: y (M <= 8, N) = x @ W for the policies with codes(), as
// y^T = W^T x^T on mma.sync m16n8k16 (gemv_mma.cuh's fragment map: lane
// 4g + t owns columns 16g..16g+15 of its 128-column tile and, in every
// k16 step, K rows 2t, 2t+1 (A registers a0, a1) and 2t+8, 2t+9 (a2, a3);
// activation rows past M are zeros in the B fragments).
//   - Every policy stores one byte per column in each plane row, so a
//     lane's 16-byte chunk of a byte row is its 16 columns.  Its K rows'
//     bytes are the plane rows row(p, k) of a slot in shared memory; the
//     2-, 1-bit and split planes put several K rows of different lanes in
//     one byte row, which those lanes read after the slot's __syncwarp.
//   - Decode, per weight: codes() gives 4 columns' codes from their words;
//     one byte_perm puts a code under the float32 bits of 2^23 (pair codes:
//     v1 = b div 11 by a multiply-high, v0 = b - 11 v1, then an OR); minus
//     2^23 + kBias is the value, exactly.  The weight is value*scale +
//     offset in float32 with two roundings, the codec's, as one fma.rn
//     where the product is exact (f16 metadata: a code of at most 8 bits
//     times an 11-bit significand fits float32's 24 bits, so fma.rn rounds
//     the same sum once) and as mul.rn then add.rn for f32 metadata; two
//     weights of a K pair become one A register by cvt.rn.bf16x2.f32 (the
//     rounding of round_bf16).  About 4.5 instructions a weight, where
//     the CUDA-core loop spent some 18 at 8 rows.
//   - Each warp streams its quant blocks (lb = warp, warp + 8, ... of the
//     CTA's K slice) through a ring of kRing slots in dynamic shared memory,
//     one slot of kSlotK K rows (16; a whole block where a plane's byte rows
//     do not follow K in steps of 16, as Q5_B32T1's split half does): every
//     plane's byte rows of the slot, kPitch chunks (144 or 160 bytes) apart
//     so that the lanes' reads of a row pattern meet no bank twice
//     (mma_ways), and at a block's first slot its scale and base rows.  Each
//     lane copies every 32nd 16-byte chunk (cp.async; a byte row's 128 bytes
//     are 8 neighbouring lanes'), zeros past N.
//   - The CTA's activations are staged once in fragment order (frag_word);
//     the warps' sums meet in warp order, the K splits' in split order
//     (the last CTA of each column tile adds them; its counter is left
//     zero): one launch, the same bits on every run.
// What bounds it: the plane and metadata bytes (3-9 bits a weight); the
// ring keeps 3-8 slots a warp, two CTAs of 8 warps an SM.
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaCtasPerSm = 2;      // __launch_bounds__: at most 128 registers
constexpr int kMmaSumLd = 132;        // floats a row of the warps' sums (sum_slot)
constexpr int kMmaRingBudget = 9216;  // bytes of a warp's ring at most (3 slots at least)
constexpr int kMmaSmemBudget = 106496;  // dynamic shared memory of a CTA: two fit an SM
constexpr int kMmaMaxKc = 2048;       // K rows a CTA at most

template <class D>
__host__ __device__ constexpr int mma_rows(int p) {
  return p == 0 ? D::kRows0 : p == 1 ? D::kRows1 : D::kRows2;
}

// whether plane p's byte rows follow K in steps of 16 rows: K rows 16s ..
// 16s + 15 of a block are rows 16s * rows / kBlock + row(p, 0..15)
template <class D>
__host__ __device__ constexpr bool mma_linear(int p) {
  const int per = 16 * mma_rows<D>(p) / D::kBlock;
  for (int k = 0; k < D::kBlock; ++k)
    if (D::row(p, k) != (k / 16) * per + D::row(p, k % 16) || D::row(p, k % 16) >= per)
      return false;
  return true;
}

template <class D>
__host__ __device__ constexpr int mma_slot_k() {
  for (int p = 0; p < 3; ++p)
    if (mma_rows<D>(p) && !mma_linear<D>(p)) return D::kBlock;
  return 16;
}

// plane p's byte rows in a slot, and the first of them in the slot's rows
template <class D>
__host__ __device__ constexpr int mma_slot_rows(int p) {
  return mma_rows<D>(p) * mma_slot_k<D>() / D::kBlock;
}
template <class D>
__host__ __device__ constexpr int mma_first_row(int p) {
  return p == 0 ? 0 : p == 1 ? mma_slot_rows<D>(0) : mma_slot_rows<D>(0) + mma_slot_rows<D>(1);
}

// whether K rows k and k + 1 (k even) share plane p's byte row
template <class D>
__host__ __device__ constexpr bool mma_pair_row(int p) {
  for (int k = 0; k < D::kBlock; k += 2)
    if (D::row(p, k) != D::row(p, k + 1)) return false;
  return true;
}

// The bank conflicts of the lanes' chunk reads at a row pitch of `pitch`
// chunks: for every plane, K row pattern (2t + d, d in {0, 1, 8, 9}) and
// quarter warp (8 lanes, groups 2q and 2q + 1, t = 0..3: one phase of a
// 16-byte load), the distinct chunks beyond one per 16-byte bank group.
template <class D>
__host__ __device__ constexpr int mma_ways(int pitch) {
  int total = 0;
  const int ds[4] = {0, 1, 8, 9};
  for (int p = 0; p < 3; ++p) {
    if (!mma_rows<D>(p)) continue;
    for (int st = 0; st < mma_slot_k<D>() / 16; ++st)
      for (int di = 0; di < 4; ++di)
        for (int q = 0; q < 4; ++q) {
          int addr[8] = {}, n = 0, count[8] = {}, worst = 0;
          for (int l = 0; l < 8; ++l) {
            const int a = D::row(p, 16 * st + 2 * (l % 4) + ds[di]) * pitch + 2 * q + l / 4;
            bool seen = false;
            for (int i = 0; i < n; ++i) seen = seen || addr[i] == a;
            if (!seen) addr[n++] = a;
          }
          for (int i = 0; i < n; ++i) {
            const int c = ++count[addr[i] % 8];
            worst = c > worst ? c : worst;
          }
          total += worst - 1;
        }
  }
  return total;
}

template <class D>
__host__ __device__ constexpr int mma_pitch() {
  int best = 8;
  for (int pitch = 9; pitch <= 12; ++pitch)
    if (mma_ways<D>(pitch) < mma_ways<D>(best)) best = pitch;
  return best;
}

// The layout of a policy's ring slot (16-byte chunks) and of the CTA's
// dynamic shared memory: the B fragments of at most kMaxKc K rows, then
// the warps' rings, which hold the warps' sums after the walk.
template <class D>
struct MmaGeo {
  using Meta = typename D::Meta;
  static constexpr int kSlotK = mma_slot_k<D>();  // K rows a slot
  static constexpr int kSteps = kSlotK / 16;       // k16 steps a slot
  static constexpr int kSlotsPerBlock = D::kBlock / kSlotK;
  static constexpr int kCodeRows =
      mma_slot_rows<D>(0) + mma_slot_rows<D>(1) + mma_slot_rows<D>(2);
  static constexpr int kPitch = mma_pitch<D>();
  static constexpr int kMetaPer = 128 * (int)sizeof(Meta) / 16;  // chunks of a metadata row
  static constexpr int kMeta = kMetaPer * (D::kBase ? 2 : 1);    // scale, then base
  static constexpr int kMetaAt = kCodeRows * kPitch;
  static constexpr int kSlot = kMetaAt + kMeta;  // chunks
  static constexpr int kRing =
      kMmaRingBudget / (kSlot * 16) < 3 ? 3
      : kMmaRingBudget / (kSlot * 16) > 8 ? 8 : kMmaRingBudget / (kSlot * 16);
  static constexpr int kRingBytes = kMmaWarps * kRing * kSlot * 16;
  static constexpr int kSumBytes = kMmaWarps * 8 * kMmaSumLd * 4;
  static constexpr int kWorkBytes = kRingBytes > kSumBytes ? kRingBytes : kSumBytes;
  // K rows a CTA: 2048, or the largest power of two whose fragments fit
  static constexpr int kMaxKc =
      (kMmaSmemBudget - kWorkBytes) / 16 >= kMmaMaxKc ? kMmaMaxKc
      : (kMmaSmemBudget - kWorkBytes) / 16 >= 1024    ? 1024
                                                      : 512;
  static constexpr int kSmem = kMaxKc * 16 + kWorkBytes;
  static constexpr int kCodeIters = (kCodeRows * 8 + 31) / 32;  // code chunks a lane copies
  static constexpr int kMetaIters = (kMeta + 31) / 32;
  static_assert(kMaxKc % D::kBlock == 0 && kMaxKc * 16 + kWorkBytes <= kMmaSmemBudget,
                "the fragments and the rings fit");
};

// value*scale + offset from a code under the float32 bits of 2^23
// (0x4B000000 | code): the codec's two roundings
template <class D>
__device__ __forceinline__ float mma_weight(uint32_t bits, float sc, float off) {
  const float v = __fsub_rn(__uint_as_float(bits), 8388608.f + D::kBias);  // exact
  if constexpr (!D::kBase) {
    return __fmul_rn(v, sc);
  } else if constexpr (std::is_same<typename D::Meta, __half>::value) {
    return __fmaf_rn(v, sc, off);  // v * sc is exact: one rounding, as add.rn's
  } else {
    return __fadd_rn(__fmul_rn(v, sc), off);
  }
}

// Grid (ceil(N / 128), ksplit); CTA y takes the K rows [y * kc, y * kc +
// kc) (kc = kb_per_split quant blocks; the last CTA fewer).  partial
// (ksplit, M, N) floats and counters (one per column tile, zero on entry,
// left zero) serve ksplit > 1.
template <class D>
__global__ void __launch_bounds__(kMmaThreads, kMmaCtasPerSm)
dq_gemv_mma(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data0,
            const uint8_t* __restrict__ data1, const uint8_t* __restrict__ data2,
            const typename D::Meta* __restrict__ scale, const typename D::Meta* __restrict__ base,
            float* __restrict__ partial, int* __restrict__ counters,
            __nv_bfloat16* __restrict__ out, int M, int K, int N, int kc) {
  using namespace gemv_mma;
  using G = MmaGeo<D>;
  using Meta = typename D::Meta;
  constexpr int kBlock = D::kBlock, kRing = G::kRing, kSlot = G::kSlot, kPitch = G::kPitch;
  extern __shared__ uint4 smem_mma[];
  uint2* xb = reinterpret_cast<uint2*>(smem_mma);  // B fragments of the CTA's K slice
  uint4* rings = smem_mma + G::kMaxKc;             // kMaxKc * 16 bytes on
  __shared__ int last_s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x, k0 = blockIdx.y * kc, klen = min(kc, K - k0);
  const int col0 = tile * 128;
  uint4* ring = rings + warp * kRing * kSlot;

  const int nblk = klen / kBlock;
  const int nslots =
      warp < nblk ? ((nblk - 1 - warp) / kMmaWarps + 1) * G::kSlotsPerBlock : 0;
  // slot u: K rows j * kSlotK .. + kSlotK - 1 (j = u % kSlotsPerBlock) of
  // the warp's block u / kSlotsPerBlock: each plane's byte rows, then at a
  // block's first slot its scale and base rows
  auto issue = [&](int u) {
    if (u < nslots) {
      const int lb = warp + (u / G::kSlotsPerBlock) * kMmaWarps, j = u % G::kSlotsPerBlock;
      const int kb = k0 / kBlock + lb;
      uint4* s = ring + (u % kRing) * kSlot;
#pragma unroll
      for (int it = 0; it < G::kCodeIters; ++it) {
        const int i = lane + 32 * it;
        if (i < G::kCodeRows * 8) {
          const int r = i / 8, cg = i % 8;
          const int p = r < mma_first_row<D>(1) ? 0 : r < mma_first_row<D>(2) ? 1 : 2;
          const int srow = mma_slot_rows<D>(p);
          const size_t grow =
              (size_t)kb * mma_rows<D>(p) + j * srow + (r - mma_first_row<D>(p));
          const int c = col0 + 16 * cg, valid = min(max(N - c, 0), 16);
          const uint8_t* plane = p == 0 ? data0 : p == 1 ? data1 : data2;
          cp_async_chunk(&s[r * kPitch + cg], valid ? plane + grow * N + c : plane, valid, 16);
        }
      }
      if (j == 0) {
#pragma unroll
        for (int it = 0; it < G::kMetaIters; ++it) {
          const int i = lane + 32 * it;
          if (i < G::kMeta) {
            const char* src = reinterpret_cast<const char*>(i < G::kMetaPer ? scale : base);
            const int c = i % G::kMetaPer;
            const long long at = ((long long)kb * N + col0) * (long long)sizeof(Meta) + 16 * c;
            const int valid =
                (int)min(max((long long)N * (long long)sizeof(Meta) -
                                 (col0 * (long long)sizeof(Meta) + 16 * c),
                             0LL),
                         16LL);
            cp_async_chunk(&s[G::kMetaAt + i], valid ? src + at : src, valid, 16);
          }
        }
      }
    }
    cp_async_commit();
  };

  // the activations' loads first (they would queue behind the weight
  // stream), then the ring's first slots, then the fragments into place
  {
    constexpr int kXIters = G::kMaxKc / kMmaThreads;  // 8 rows x kMaxKc / 8 chunks
    const int nch = klen / 8;
    uint4 xv[kXIters];
#pragma unroll
    for (int it = 0; it < kXIters; ++it) {
      const int i = it * kMmaThreads + tid, m = i / nch, c = 8 * (i - m * nch);
      if (i < M * nch) xv[it] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c));
    }
#pragma unroll
    for (int u = 0; u < kRing - 1; ++u) issue(u);
    uint32_t* xw = reinterpret_cast<uint32_t*>(xb);
#pragma unroll
    for (int it = 0; it < kXIters; ++it) {
      const int i = it * kMmaThreads + tid, m = i / nch, c = 8 * (i - m * nch);
      if (i < M * nch) {
        xw[frag_word(m, c)] = xv[it].x, xw[frag_word(m, c + 2)] = xv[it].y;
        xw[frag_word(m, c + 4)] = xv[it].z, xw[frag_word(m, c + 6)] = xv[it].w;
      }
    }
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  float sc[16], off[16];  // the block's scale and offset of each of the lane's columns
#pragma unroll 1
  for (int u = 0; u < nslots; ++u) {
    __syncwarp();  // every lane has read the slot refilled next
    issue(u + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncwarp();  // the slot's chunks came from every lane
    const uint4* sl = ring + (u % kRing) * kSlot;
    const int lb = warp + (u / G::kSlotsPerBlock) * kMmaWarps, j = u % G::kSlotsPerBlock;
    if (j == 0) {  // the group's 16 columns: 32 bytes of f16, 64 of f32
      constexpr int kPer = 16 / sizeof(Meta);  // values a chunk
#pragma unroll
      for (int h = 0; h < 16 / kPer; ++h) {
        const uint4 cs = sl[G::kMetaAt + (16 / kPer) * g + h];
        uint4 cb = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (D::kBase) cb = sl[G::kMetaAt + G::kMetaPer + (16 / kPer) * g + h];
        const Meta* ms = reinterpret_cast<const Meta*>(&cs);
        const Meta* mb = reinterpret_cast<const Meta*>(&cb);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          sc[h * kPer + i] = to_float(ms[i]);
          off[h * kPer + i] = D::offset(sc[h * kPer + i], to_float(mb[i]));
        }
      }
    }
#pragma unroll 1  // one step a slot but Q5_B32T1's two: unrolled, they spill
    for (int st = 0; st < G::kSteps; ++st) {
      // B column g is activation row g: zeros past M (never staged)
      const int s16 = (lb * kBlock + j * G::kSlotK) / 16 + st;
      const uint2 b = g < M ? xb[s16 * 32 + lane] : make_uint2(0u, 0u);
      // each plane's chunks of the lane's K rows 2t + 8h + e of the step
      uint4 ch[3][2][2];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ch[p][h][e] = make_uint4(0u, 0u, 0u, 0u);
            if (mma_rows<D>(p) == 0 || (e == 1 && (D::kPair || mma_pair_row<D>(p)))) continue;
            const int row = mma_first_row<D>(p) + D::row(p, 16 * st + 2 * t + 8 * h + e);
            ch[p][h][e] = sl[row * kPitch + g];
          }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        uint32_t a[4][2];  // [byte c of the words][pair h]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * st + 2 * t + 8 * h;
          if constexpr (D::kPair) {
            const uint32_t pc = D::codes(chunk_word(ch[0][h][0], v), chunk_word(ch[1][h][0], v),
                                         chunk_word(ch[2][h][0], v), k);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint32_t bb = __byte_perm(pc, 0u, 0x4440u | c);
              const uint32_t v1 = __umulhi(bb, 0x1745D175u), v0 = bb - 11u * v1;
              a[c][h] = pack_bf16(mma_weight<D>(0x4B000000u | v0, sc[4 * v + c], off[4 * v + c]),
                                  mma_weight<D>(0x4B000000u | v1, sc[4 * v + c], off[4 * v + c]));
            }
          } else {
            uint32_t lo_w[3], hi_w[3];
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              lo_w[p] = chunk_word(ch[p][h][0], v);
              hi_w[p] = mma_pair_row<D>(p) ? lo_w[p] : chunk_word(ch[p][h][1], v);
            }
            const uint32_t lo = D::codes(lo_w[0], lo_w[1], lo_w[2], k);
            const uint32_t hi = D::codes(hi_w[0], hi_w[1], hi_w[2], k + 1);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              a[c][h] = pack_bf16(
                  mma_weight<D>(__byte_perm(lo, 0x4B000000u, 0x7540u | c), sc[4 * v + c],
                                off[4 * v + c]),
                  mma_weight<D>(__byte_perm(hi, 0x4B000000u, 0x7540u | c), sc[4 * v + c],
                                off[4 * v + c]));
          }
        }
        mma(acc[2 * v], a[0][0], a[1][0], a[0][1], a[1][1], b);
        mma(acc[2 * v + 1], a[2][0], a[3][0], a[2][1], a[3][1], b);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums in warp order (sum_slot's conflict-free layout in the
  // freed rings), then the K splits' in split order by the tile's last CTA
  float* red = reinterpret_cast<float*>(rings);
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + e % 2;
      if (m < M) red[sum_slot(warp * 8 + m, 16 * g + 2 * q + e / 2, kMmaSumLd)] = acc[q][e];
    }
  __syncthreads();
  const int ks = gridDim.y;
  for (int i = tid; i < M * 128; i += kMmaThreads) {
    const int m = i / 128, c = i % 128, cc = col0 + c;
    float v = red[sum_slot(m, c, kMmaSumLd)];
#pragma unroll
    for (int wp = 1; wp < kMmaWarps; ++wp) v = __fadd_rn(v, red[sum_slot(wp * 8 + m, c, kMmaSumLd)]);
    if (cc < N) {
      if (ks == 1)
        out[(size_t)m * N + cc] = __float2bfloat16_rn(v);
      else
        partial[((size_t)blockIdx.y * M + m) * N + cc] = v;
    }
  }
  if (ks == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&counters[tile], 1) == ks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every element of the thread (at most 4), four splits at a time with
  // all their loads in flight, each element's splits added in split order
  constexpr int kE = 8 * 128 / kMmaThreads;
  const size_t stride = (size_t)M * N;
  float sum[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) sum[e] = 0.f;
  for (int z0 = 0; z0 < ks; z0 += 4) {
    float f[kE][4];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = tid + e * kMmaThreads, cc = col0 + i % 128;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        f[e][d] = i < M * 128 && cc < N && z0 + d < ks
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
    const int i = tid + e * kMmaThreads, cc = col0 + i % 128;
    if (i < M * 128 && cc < N) out[(size_t)(i / 128) * N + cc] = __float2bfloat16_rn(sum[e]);
  }
  if (tid == 0) counters[tile] = 0;
}

// ---------------------------------------------------------------- decode
constexpr int kGemvWarps = 4;
constexpr int kGemvCols = 128;  // 32 lanes x 4 columns
constexpr int kGemvMaxKRows = 512;  // K rows per CTA (x staging)

// y (M, N) = x @ W on the CUDA cores, launched at M = 1 only
// (loop_at_one_row's route; the template's text is kept as it was built at
// every M: ptxas gave a one-row rewrite 32 registers against this one's 40
// and the B5 one row 12-19% more time on an H100; PERF.md).
template <class D, int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
dq_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data0,
        const uint8_t* __restrict__ data1, const uint8_t* __restrict__ data2,
        const typename D::Meta* __restrict__ scale,
        const typename D::Meta* __restrict__ base, float* __restrict__ partial,
        __nv_bfloat16* __restrict__ out, int K, int N, int kb_per_split,
        int ksplit) {
  constexpr int kBlock = D::kBlock, R0 = D::kRows0, R1 = D::kRows1, R2 = D::kRows2;
  __shared__ float xs[M][kGemvMaxKRows];
  __shared__ float red[kGemvWarps][M][kGemvCols];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kGemvCols + lane * 4;
  const int split = blockIdx.y;
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(kb_begin + kb_per_split, K / kBlock);
  const int k_begin = kb_begin * kBlock;
  const int k_len = max(kb_end - kb_begin, 0) * kBlock;

  for (int i = threadIdx.x; i < M * k_len; i += blockDim.x) {
    const int m = i / k_len;
    const int kk = i - m * k_len;
    xs[m][kk] = __bfloat162float(x[(size_t)m * K + k_begin + kk]);
  }
  __syncthreads();

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if (col0 < N) {  // N % 4 == 0: the whole 4-column group is in range
    for (int kb = kb_begin + warp; kb < kb_end; kb += kGemvWarps) {
      float sc[4], bs[4] = {0.f, 0.f, 0.f, 0.f}, off[4];
      load4(scale + (size_t)kb * N + col0, sc);
      if constexpr (D::kBase) load4(base + (size_t)kb * N + col0, bs);
#pragma unroll
      for (int j = 0; j < 4; ++j) off[j] = D::offset(sc[j], bs[j]);
      // every plane row of the quant block in flight at once
      uint32_t w0[R0], w1[R1 > 0 ? R1 : 1], w2[R2 > 0 ? R2 : 1];
      const uint8_t* p0 = data0 + (size_t)kb * R0 * N + col0;
#pragma unroll
      for (int r = 0; r < R0; ++r)
        w0[r] = __ldg(reinterpret_cast<const uint32_t*>(p0 + (size_t)r * N));
      if constexpr (R1 > 0) {
        const uint8_t* p1 = data1 + (size_t)kb * R1 * N + col0;
#pragma unroll
        for (int r = 0; r < R1; ++r)
          w1[r] = __ldg(reinterpret_cast<const uint32_t*>(p1 + (size_t)r * N));
      }
      if constexpr (R2 > 0) {
        const uint8_t* p2 = data2 + (size_t)kb * R2 * N + col0;
#pragma unroll
        for (int r = 0; r < R2; ++r)
          w2[r] = __ldg(reinterpret_cast<const uint32_t*>(p2 + (size_t)r * N));
      }
      const int kk0 = (kb - kb_begin) * kBlock;
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = (w0[D::row(0, k)] >> (8 * j)) & 0xFFu;
          uint32_t b1 = 0, b2 = 0;
          if constexpr (R1 > 0) b1 = (w1[D::row(1, k)] >> (8 * j)) & 0xFFu;
          if constexpr (R2 > 0) b2 = (w2[D::row(2, k)] >> (8 * j)) & 0xFFu;
          const float w =
              round_bf16(dequant<D>(D::value(b0, b1, b2, k), sc[j], off[j]));
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m][j] = fmaf(xs[m][kk0 + k], w, acc[m][j]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();

  for (int i = threadIdx.x; i < M * kGemvCols; i += blockDim.x) {
    const int m = i / kGemvCols;
    const int c = i - m * kGemvCols;
    const int col = blockIdx.x * kGemvCols + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][m][c];
    if (ksplit == 1)
      out[(size_t)m * N + col] = __float2bfloat16_rn(s);
    else
      partial[((size_t)split * M + m) * N + col] = s;
  }
}

__global__ void splitk_reduce(const float* __restrict__ partial,
                              __nv_bfloat16* __restrict__ out, int mn,
                              int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * mn + i];
  out[i] = __float2bfloat16_rn(s);
}

// --------------------------------------------------------------- prefill
constexpr int kBM = 64, kBN = 64;
constexpr int kLdw = kBN + 8;  // bf16 elements
constexpr int kLdc = kBN + 4;  // float elements
constexpr int kGemmThreads = 128;

// The K step of the tiled kernel is one quant block (kBK = 64, 32 or 16
// rows): shared memory for the x tile and the dequantized W tile, reused
// for the float output tile at the end.
template <int kBK>
struct GemmSmem {
  // bf16 elements: a row is kBK*2 + 16 bytes (48 at kBK = 16), so every
  // 16-row WMMA fragment starts 32-byte aligned
  static constexpr int kLdx = kBK + 8;
  static constexpr int kTileBytes = (kBM * kLdx + kBK * kLdw) * 2;
  static constexpr int kOutBytes = kBM * kLdc * 4;
  static constexpr int kBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;
};

template <class D>
__global__ void __launch_bounds__(kGemmThreads)
dq_gemm(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data0,
        const uint8_t* __restrict__ data1, const uint8_t* __restrict__ data2,
        const typename D::Meta* __restrict__ scale,
        const typename D::Meta* __restrict__ base,
        __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int kBK = D::kBlock, R0 = D::kRows0, R1 = D::kRows1, R2 = D::kRows2;
  constexpr int kLdx = GemmSmem<kBK>::kLdx;
  __shared__ __align__(128) unsigned char smem[GemmSmem<kBK>::kBytes];
  __shared__ float sc_s[kBN], off_s[kBN];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + kBM * kLdx;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2x2 warps of 32x32
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kb = k0 / kBK;
    if (tid < kBN) {
      const int col = n0 + tid;
      const float sc = col < N ? to_float(scale[(size_t)kb * N + col]) : 0.f;
      float bs = 0.f;
      if constexpr (D::kBase)
        bs = col < N ? to_float(base[(size_t)kb * N + col]) : 0.f;
      sc_s[tid] = sc;
      off_s[tid] = D::offset(sc, bs);
    }
    // x tile: 64 rows x kBK bf16, 16-byte chunks (rows past M are zeros)
    for (int c = tid; c < kBM * (kBK / 8); c += kGemmThreads) {
      const int row = c / (kBK / 8);
      const int ch = c % (kBK / 8);
      const int gm = m0 + row;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + ch * 8);
      *reinterpret_cast<uint4*>(xs + row * kLdx + ch * 8) = v;
    }
    __syncthreads();  // sc_s / off_s visible
    // W tile: kBK K rows x 64 columns; each item one K row of a 16-column
    // run, its bytes of every plane read as one 16-byte load each
    for (int it = tid; it < kBK * (kBN / 16); it += kGemmThreads) {
      const int k = it / (kBN / 16);
      const int c0 = (it % (kBN / 16)) * 16;
      const int col = n0 + c0;
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0, v2 = v0;
      if (col < N) {  // N % 16 == 0: the 16-column run is in range
        v0 = *reinterpret_cast<const uint4*>(
            data0 + ((size_t)kb * R0 + D::row(0, k)) * N + col);
        if constexpr (R1 > 0)
          v1 = *reinterpret_cast<const uint4*>(
              data1 + ((size_t)kb * R1 + D::row(1, k)) * N + col);
        if constexpr (R2 > 0)
          v2 = *reinterpret_cast<const uint4*>(
              data2 + ((size_t)kb * R2 + D::row(2, k)) * N + col);
      }
      const uint8_t* b0 = reinterpret_cast<const uint8_t*>(&v0);
      const uint8_t* b1 = reinterpret_cast<const uint8_t*>(&v1);
      const uint8_t* b2 = reinterpret_cast<const uint8_t*>(&v2);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ws[k * kLdw + c0 + i] = __float2bfloat16_rn(dequant<D>(
            D::value(b0[i], b1[i], b2[i], k), sc_s[c0 + i], off_s[c0 + i]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * kLdx + kk, kLdx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], ws + kk * kLdw + wn * 32 + j * 16, kLdw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // tiles consumed before the next step overwrites them
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16,
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN, c = e % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      out[(size_t)gm * N + gn] = __float2bfloat16_rn(cs[r * kLdc + c]);
  }
}

// The plan of dq_gemv for one row of K x N weights in `block`-row quant
// blocks (64, 32 or 16) on a card of `sm_count` SMs: *ksplit K splits of
// *kb_per_split quant blocks (at most kGemvMaxKRows rows), enough CTAs for
// about two per SM.  The caller allocates ksplit * N floats of workspace
// when *ksplit > 1.
void plan_gemv_row(int K, int N, int block, int sm_count, int* kb_per_split, int* ksplit) {
  const int nkb = K / block;
  const int max_per = kGemvMaxKRows / block;
  const int n_tiles = (N + kGemvCols - 1) / kGemvCols;
  const int want = (2 * sm_count + n_tiles - 1) / n_tiles;
  int split = std::min(want, std::max(nkb / 4, 1));
  split = std::max(split, (nkb + max_per - 1) / max_per);
  split = std::min(split, nkb);
  const int per = (nkb + split - 1) / split;
  *kb_per_split = per;
  *ksplit = (nkb + per - 1) / per;
}

// One row on a single plane of at most 4 bits (Q4_B64T1, Q4_B32T1A/B,
// Q4_B32T2, Q4_B16 in their wire planes and, B5, in the i4 layout;
// Q2_B32T1A/B) or on a split plane (Q5_B32T1, whose slot is a whole block)
// stays on dq_gemv: at one row dq_gemv_mma is slower than this loop on
// these planes (PERF.md gives both times; B5 at llama2-7b's w1n3 6-9% and
// at its lm_head 2-9% on an H100); every other policy and row count takes
// dq_gemv_mma.
template <class D>
constexpr bool loop_at_one_row() {
  return (D::kRows1 == 0 && !D::kPair && 2 * D::kRows0 <= D::kBlock) || mma_slot_k<D>() > 16;
}

// y = x @ dequant(W) for a policy of the tensor-core GEMV, with a plan
// from plan_matmul_mma: M <= 8 runs dq_gemv_mma (kb_per_split quant blocks
// a CTA, ksplit CTAs a column tile; partial holds ksplit * M * N floats and
// counters one zero int per column tile when ksplit > 1; loop_at_one_row:
// dq_gemv and splitk_reduce at M = 1), larger M dq_gemm.
// A decode plan that does not cover K exactly once or takes more than
// kMaxKc rows a CTA is refused with cudaErrorInvalidValue, as is a missing
// base, plane, workspace or counter buffer.
template <class D>
int run_matmul_mma(const void* x, const void* data0, const void* data1, const void* data2,
                   const void* scale, const void* base, void* out, void* workspace,
                   void* counters, int M, int K, int N, int kb_per_split, int ksplit,
                   void* stream_ptr) {
  constexpr int kBlock = D::kBlock;
  using Meta = typename D::Meta;
  if (M <= 0 || K <= 0 || K % kBlock || N <= 0 || N % 16 || (D::kBase && base == nullptr) ||
      (D::kRows1 > 0 && data1 == nullptr) || (D::kRows2 > 0 && data2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* d0 = static_cast<const uint8_t*>(data0);
  auto* d1 = static_cast<const uint8_t*>(data1);
  auto* d2 = static_cast<const uint8_t*>(data2);
  auto* sc = static_cast<const Meta*>(scale);
  auto* bs = static_cast<const Meta*>(base);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if constexpr (loop_at_one_row<D>()) {
    if (M == 1) {
      const int nkb = K / kBlock;
      if (kb_per_split < 1 || kb_per_split * kBlock > kGemvMaxKRows || ksplit < 1 ||
          kb_per_split * ksplit < nkb || kb_per_split * (ksplit - 1) >= nkb ||
          (ksplit > 1 && workspace == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
      auto* ws = static_cast<float*>(workspace);
      dq_gemv<D, 1><<<dim3((N + kGemvCols - 1) / kGemvCols, ksplit), kGemvWarps * 32, 0, stream>>>(
          xb, d0, d1, d2, sc, bs, ws, ob, K, N, kb_per_split, ksplit);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
      splitk_reduce<<<(N + 255) / 256, 256, 0, stream>>>(ws, ob, N, ksplit);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (M <= 8) {
    const int nkb = K / kBlock;
    if (kb_per_split < 1 || kb_per_split * kBlock > MmaGeo<D>::kMaxKc || ksplit < 1 ||
        kb_per_split * ksplit < nkb || kb_per_split * (ksplit - 1) >= nkb ||
        (ksplit > 1 && (workspace == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    // the rings' dynamic shared memory (above the 48 KB a kernel gets
    // without asking), with the SM's memory preferred as shared memory
    static const cudaError_t ready = [] {
      cudaError_t e = cudaFuncSetAttribute(dq_gemv_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           MmaGeo<D>::kSmem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(dq_gemv_mma<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      return e;
    }();
    if (ready != cudaSuccess) return static_cast<int>(ready);
    dq_gemv_mma<D><<<dim3((N + 127) / 128, ksplit), kMmaThreads, MmaGeo<D>::kSmem, stream>>>(
        xb, d0, d1, d2, sc, bs, static_cast<float*>(workspace), static_cast<int*>(counters), ob,
        M, K, N, kb_per_split * kBlock);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dq_gemm<D><<<grid, kGemmThreads, 0, stream>>>(xb, d0, d1, d2, sc, bs, ob, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The plan of dq_gemv_mma for an (M <= 8, K) x (K, N) product on a card of
// `sm_count` SMs: the K split (whole quant blocks, at most kMaxKc rows a
// CTA) whose waves of kMmaCtasPerSm CTAs an SM cost least, a wave costing
// its CTAs' weight bytes plus a CTA's fixed cost (the activation staging
// and the ring's first fill before the walk, the warps' sums and the
// split merge after it: 10-16 us a CTA of decode_step.cu's walk on the
// card), counted as kMmaCtaCost bytes, about what a CTA streams in that
// time; one wave wherever it fits.  *kb_per_split = quant blocks a CTA,
// *ksplit = CTAs a column tile (loop_at_one_row at M = 1: plan_gemv_row's
// plan of dq_gemv); larger M the tiled path (0, 1).
constexpr long long kMmaCtaCost = 96 * 1024;
template <class D>
int plan_matmul_mma(int M, int K, int N, int sm_count, int* kb_per_split, int* ksplit) {
  constexpr int unit = D::kBlock, max_kc = MmaGeo<D>::kMaxKc;
  if (M <= 0 || K <= 0 || N <= 0 || K % unit || sm_count <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 8) {
    *kb_per_split = 0;
    *ksplit = 1;
    return 0;
  }
  if (loop_at_one_row<D>() && M == 1) {
    plan_gemv_row(K, N, unit, sm_count, kb_per_split, ksplit);
    return 0;
  }
  const int tiles = (N + 127) / 128, slots = kMmaCtasPerSm * sm_count;
  // one quant block of a tile: its plane bytes, scales and bases
  const long long blk_bytes =
      128LL * (D::kRows0 + D::kRows1 + D::kRows2 + (D::kBase ? 2 : 1) * (int)sizeof(typename D::Meta));
  long long best = -1;
  int rows_best = std::min(max_kc, (K + unit - 1) / unit * unit);
  for (int waves = 1; waves <= 16; ++waves) {
    const int want = (int)((long long)waves * slots / tiles);  // CTAs a tile
    if (want < 1) continue;
    const int rows = ((K + want - 1) / want + unit - 1) / unit * unit;
    if (rows > max_kc) continue;
    const long long splits = (K + rows - 1) / rows;
    const long long taken = (tiles * splits + slots - 1) / slots;
    const long long cost = taken * (kMmaCtaCost + rows / unit * blk_bytes);
    if (best < 0 || cost < best) best = cost, rows_best = rows;
  }
  *kb_per_split = rows_best / unit;
  *ksplit = (K / unit + *kb_per_split - 1) / *kb_per_split;
  return 0;
}

}  // namespace

// A C entry `name` of a policy (B1, B5, B6), inside an extern
// "C" block: (x, data, data_h, scale, base, out, workspace, counters, M, K,
// N, kb_per_split, ksplit, stream) -> the launch's cudaGetLastError(), and
// its plan `name`_plan(M, K, N, sm_count, &kb_per_split, &ksplit).
#define IFT_MATMUL_ENTRY(name, D)                                                      \
  int name(const void* x, const void* data, const void* data_h, const void* scale,     \
           const void* base, void* out, void* workspace, void* counters, int M, int K, \
           int N, int kb_per_split, int ksplit, void* stream_ptr) {                    \
    return run_matmul_mma<D>(x, data, data_h, nullptr, scale, base, out, workspace,    \
                             counters, M, K, N, kb_per_split, ksplit, stream_ptr);     \
  }                                                                                    \
  int name##_plan(int M, int K, int N, int sm_count, int* kb_per_split, int* ksplit) { \
    return plan_matmul_mma<D>(M, K, N, sm_count, kb_per_split, ksplit);                \
  }
// The same for a three-plane policy: (x, data, data_m, data_h, scale, ...)
// with the planes in the policy's order 0, 1, 2.
#define IFT_MATMUL_ENTRY3(name, D)                                                        \
  int name(const void* x, const void* data, const void* data_m, const void* data_h,       \
           const void* scale, const void* base, void* out, void* workspace, void* counters, \
           int M, int K, int N, int kb_per_split, int ksplit, void* stream_ptr) {           \
    return run_matmul_mma<D>(x, data, data_m, data_h, scale, base, out, workspace,        \
                             counters, M, K, N, kb_per_split, ksplit, stream_ptr);        \
  }                                                                                       \
  int name##_plan(int M, int K, int N, int sm_count, int* kb_per_split, int* ksplit) {    \
    return plan_matmul_mma<D>(M, K, N, sm_count, kb_per_split, ksplit);                   \
  }
