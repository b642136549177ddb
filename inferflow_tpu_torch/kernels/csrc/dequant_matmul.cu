// Dequantize-matmul for block weights stored as bytes along K:
// y = x @ dequant(W), for five byte layouts.
//
// Kernel B1 replaces inferflow_tpu/kernels/dequant_matmul.py
// `_make_fast_kernel` (its pallas_call at :505, public entry
// `quantized_matmul` at :643) for the Q4_B64T1 format in the packed wire
// layout and for the two Q8 block formats, Q8_B32T2 (the `Q8` alias and
// the q8c container) and Q8_B32T1.  Kernel B5 replaces `_make_i4_kernel`
// (:313, its pallas_call at :452) for the `i4` device layout
// (codec_jax.repack_i4).  Kernel B6 replaces `_make_kernel` (:244, its
// pallas_call at :573) in its pair8 mode: Q3H_B64T1 weights in the `pair8`
// device layout (codec_torch.quantize and QuantizedTensor.from_np give Q3H
// in it).
//
// Operands (row-major):
//   x     (M, K)   bf16 activations
//   data  (K/R, N) uint8: byte r holds K rows R*r .. R*r+R-1 of its column,
//                  R = 2 for the 4-bit and pair layouts, 1 for Q8
//   scale (K/B, N) f16 per-block scales, B = 64 (4-bit, pair) or 32 (Q8)
//   base  (K/B, N) f16 per-block bases; absent (null) for Q8_B32T2
//   out   (M, N)   bf16
// The layouts differ only in how a byte decodes into the values of its
// rows and in the block's additive term (the `Decode` policies below), so
// all five run the same two kernels, templated on the policy, whose rows
// per byte and block size set the geometry:
//   B1, Q4 wire planes: the low nibble is row 2r's code q in 0..15, the
//       high nibble row 2r+1's, and the weight is w = bf16(q*scale + base);
//   B1, Q8_B32T2: the byte is row r's code, a signed q in -128..127, and
//       w = bf16(q*scale) (zero base);
//   B1, Q8_B32T1: the byte is row r's code q in 0..255, and
//       w = bf16(q*scale + base);
//   B5, i4 layout: each nibble is (q - 8) & 0xF (the wire byte XOR 0x88),
//       read as a signed n in -8..7, and the weight is
//       w = bf16(n*scale + fold) with fold = 8*scale + base in float32, as
//       the TPU kernel folds the +8 into the block's additive term;
//   B6, pair8: the byte is the base-11 pair code b = v0 + 11*v1, row 2r
//       takes v0 = b - 11*(b / 11) and row 2r+1 v1 = b / 11 (the TPU
//       kernel's floor((b + 0.5) / 11), exact for every byte value), and
//       the weight is w = bf16(v*scale + base), codec_torch.dequantize's
//       weight bit for bit.
// Each weight is two rounded float32 operations (no fused multiply-add),
// rounded to bf16, and the products accumulate in float32: the codec's
// weights, so kernel and plain version differ in summation order only.
// (The TPU kernel rounds the block scale to bf16 before the multiply; the
// port follows the codec, a difference ROADMAP section C records.)  Pad
// blocks of a K-padded tensor have scale 0 and base 0 and add exact zeros.
//
// What bounds it on the H100: at decode (M <= 8) every weight byte is used
// by M rows only, so the kernel is bound by the bytes of the weight planes
// (4.5 bits per weight with the metadata for the 4-bit and pair layouts,
// 8.5 for Q8_B32T2, 9 for Q8_B32T1).  At prefill (M in the hundreds) the
// same bytes feed M rows and the bf16 tensor-core work dominates.  B6's
// decode per byte is an integer division by a constant (a multiply-high
// and a shift) where B1 and B5 take two shifts; at M <= 8 that is integer
// work beside the same bytes.
//
// What the design does about it:
//   - decode (`q4_gemv`): neighbouring threads own neighbouring 4-column
//     groups, so each warp reads 128 contiguous bytes of a plane row (one
//     32-bit load: 4 columns of R K rows) and 8 contiguous bytes of
//     scale/base per quant block; every layout's quant block is 32 byte
//     rows, whose loads a warp issues all at once before using any
//     (memory-level parallelism); K is split over the warps of a CTA and
//     over CTAs (about two CTAs per SM, from the SM count the caller reads
//     off the device: `ift_matmul_plan`), with the x slice of the CTA (at
//     most kGemvMaxKRows rows) staged once in shared memory and one
//     float32 accumulator per (row, column) in registers; the split-K
//     partial sums are added in a fixed order by a second small kernel
//     (deterministic).
//   - prefill (`q4_gemm`, also every M > 8): 64x64 output tiles; per
//     quant block of K (64 or 32 rows) the CTA stages the x tile and
//     dequantizes the W tile into shared memory as bf16, then runs bf16
//     WMMA 16x16x16 products with float32 accumulators.  No copy
//     pipelining yet (later work: TMA + wgmma).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// How a byte decodes.  kRows: K rows per byte; kBlock: K rows per quant
// block (every policy's block is kBlockRows = 32 byte rows); kBase: whether
// the format stores a base (read only then).  offset(): the block's
// additive term from its scale and base; values(): the multipliers of the
// byte's kRows K rows, in order.  The weight is value*scale + offset as two
// rounded float32 operations (no fused multiply-add), so it equals the
// plain version's bit for bit before the bf16 rounding.
constexpr int kBlockRows = 32;  // byte rows per quant block, every layout

struct WireQ4 {  // B1: Q4_B64T1 wire planes, w = q*scale + base
  static constexpr int kRows = 2, kBlock = 64;
  static constexpr bool kBase = true;
  __device__ static float offset(float scale, float base) { return base; }
  __device__ static void values(uint32_t b, float v[kRows]) {
    v[0] = float(b & 0xFu);
    v[1] = float(b >> 4);
  }
};
struct PackedI4 {  // B5: i4 layout, w = n*scale + (8*scale + base)
  static constexpr int kRows = 2, kBlock = 64;
  static constexpr bool kBase = true;
  __device__ static float offset(float scale, float base) {
    return __fadd_rn(__fmul_rn(scale, 8.f), base);
  }
  __device__ static void values(uint32_t b, float v[kRows]) {
    v[0] = float(int((b & 0xFu) ^ 8u) - 8);
    v[1] = float(int((b >> 4) ^ 8u) - 8);
  }
};
struct Pair8 {  // B6: Q3H pair8, b = v0 + 11*v1, w = v*scale + base
  static constexpr int kRows = 2, kBlock = 64;
  static constexpr bool kBase = true;
  __device__ static float offset(float scale, float base) { return base; }
  __device__ static void values(uint32_t b, float v[kRows]) {
    const uint32_t v1 = b / 11u;
    v[0] = float(b - 11u * v1);
    v[1] = float(v1);
  }
};
struct Q8Signed {  // B1: Q8_B32T2, signed codes, w = q*scale (no base)
  static constexpr int kRows = 1, kBlock = 32;
  static constexpr bool kBase = false;
  __device__ static float offset(float, float) { return 0.f; }
  __device__ static void values(uint32_t b, float v[kRows]) {
    v[0] = float(int(b ^ 0x80u) - 128);
  }
};
struct Q8Unsigned {  // B1: Q8_B32T1, codes 0..255, w = q*scale + base
  static constexpr int kRows = 1, kBlock = 32;
  static constexpr bool kBase = true;
  __device__ static float offset(float scale, float base) { return base; }
  __device__ static void values(uint32_t b, float v[kRows]) { v[0] = float(b); }
};

template <class Decode>
__device__ __forceinline__ float dequant(float value, float scale, float offset) {
  if constexpr (!Decode::kBase) return __fmul_rn(value, scale);
  return __fadd_rn(__fmul_rn(value, scale), offset);
}

// ---------------------------------------------------------------- decode
constexpr int kGemvWarps = 4;
constexpr int kGemvCols = 128;  // 32 lanes x 4 columns
constexpr int kGemvMaxKRows = 512;  // K rows per CTA (x staging)

template <class Decode, int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
q4_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data,
        const __half* __restrict__ scale, const __half* __restrict__ base,
        float* __restrict__ partial, __nv_bfloat16* __restrict__ out, int K,
        int N, int kb_per_split, int ksplit) {
  constexpr int R = Decode::kRows, kBlock = Decode::kBlock;
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
      const uint2 sc_bits =
          *reinterpret_cast<const uint2*>(scale + (size_t)kb * N + col0);
      uint2 bs_bits = make_uint2(0, 0);
      if constexpr (Decode::kBase)
        bs_bits = *reinterpret_cast<const uint2*>(base + (size_t)kb * N + col0);
      const __half* sch = reinterpret_cast<const __half*>(&sc_bits);
      const __half* bsh = reinterpret_cast<const __half*>(&bs_bits);
      float sc[4], off[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = __half2float(sch[j]);
        off[j] = Decode::offset(sc[j], __half2float(bsh[j]));
      }
      const uint8_t* rowp = data + (size_t)kb * kBlockRows * N + col0;
      const int kk0 = (kb - kb_begin) * kBlock;
      // all 32 plane rows of the quant block in flight at once
      uint32_t words[kBlockRows];
#pragma unroll
      for (int r = 0; r < kBlockRows; ++r)
        words[r] = __ldg(reinterpret_cast<const uint32_t*>(rowp + (size_t)r * N));
#pragma unroll
      for (int r = 0; r < kBlockRows; ++r) {
        const uint32_t bytes = words[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[R];
          Decode::values((bytes >> (8 * j)) & 0xFFu, v);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float w = round_bf16(dequant<Decode>(v[i], sc[j], off[j]));
#pragma unroll
            for (int m = 0; m < M; ++m)
              acc[m][j] = fmaf(xs[m][kk0 + R * r + i], w, acc[m][j]);
          }
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

// The K step of the tiled kernel is one quant block (kBK = 64 or 32 rows):
// shared memory for the x tile and the dequantized W tile, reused for the
// float output tile at the end.
template <int kBK>
struct GemmSmem {
  static constexpr int kLdx = kBK + 8;  // bf16 elements; rows stay 32-byte aligned
  static constexpr int kTileBytes = (kBM * kLdx + kBK * kLdw) * 2;
  static constexpr int kOutBytes = kBM * kLdc * 4;
  static constexpr int kBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;
};

template <class Decode>
__global__ void __launch_bounds__(kGemmThreads)
q4_gemm(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data,
        const __half* __restrict__ scale, const __half* __restrict__ base,
        __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int R = Decode::kRows, kBK = Decode::kBlock;
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
      const float sc = col < N ? __half2float(scale[(size_t)kb * N + col]) : 0.f;
      float bs = 0.f;
      if constexpr (Decode::kBase)
        bs = col < N ? __half2float(base[(size_t)kb * N + col]) : 0.f;
      sc_s[tid] = sc;
      off_s[tid] = Decode::offset(sc, bs);
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
    {
      // W tile: 32 byte rows x 64 columns; each thread one 16-byte run
      const int r = tid / 4;
      const int c0 = (tid % 4) * 16;
      const int col = n0 + c0;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (col < N)  // N % 16 == 0: the 16-column run is in range
        v = *reinterpret_cast<const uint4*>(
            data + ((size_t)kb * kBlockRows + r) * N + col);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float s = sc_s[c0 + i], o = off_s[c0 + i];
        float vals[R];
        Decode::values(b[i], vals);
#pragma unroll
        for (int e = 0; e < R; ++e)
          ws[(R * r + e) * kLdw + c0 + i] =
              __float2bfloat16_rn(dequant<Decode>(vals[e], s, o));
      }
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

template <class Decode, int M>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* data,
                 const __half* scale, const __half* base, float* partial,
                 __nv_bfloat16* out, int K, int N, int kb_per_split,
                 int ksplit, cudaStream_t stream) {
  dim3 grid((N + kGemvCols - 1) / kGemvCols, ksplit);
  q4_gemv<Decode, M><<<grid, kGemvWarps * 32, 0, stream>>>(
      x, data, scale, base, partial, out, K, N, kb_per_split, ksplit);
}

// y = x @ dequant(W) with a plan from ift_matmul_plan; a decode plan that
// does not cover K exactly once, or that overflows the x staging buffer,
// is refused with cudaErrorInvalidValue, as is a missing base for a
// format that has one.
template <class Decode>
int run_matmul(const void* x, const void* data, const void* scale,
               const void* base, void* out, void* workspace, int M, int K,
               int N, int kb_per_split, int ksplit, void* stream_ptr) {
  constexpr int kBlock = Decode::kBlock;
  if (M <= 0 || K <= 0 || K % kBlock || N <= 0 || N % 16 ||
      (Decode::kBase && base == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8) {
    const int nkb = K / kBlock;
    if (kb_per_split < 1 || kb_per_split * kBlock > kGemvMaxKRows || ksplit < 1 ||
        kb_per_split * ksplit < nkb || kb_per_split * (ksplit - 1) >= nkb ||
        (ksplit > 1 && workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* db = static_cast<const uint8_t*>(data);
  auto* sc = static_cast<const __half*>(scale);
  auto* bs = static_cast<const __half*>(base);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* ws = static_cast<float*>(workspace);
  if (M <= 8) {
    switch (M) {
      case 1: launch_gemv<Decode, 1>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 2: launch_gemv<Decode, 2>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 3: launch_gemv<Decode, 3>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 4: launch_gemv<Decode, 4>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 5: launch_gemv<Decode, 5>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 6: launch_gemv<Decode, 6>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 7: launch_gemv<Decode, 7>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      default: launch_gemv<Decode, 8>(xb, db, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
    const int mn = M * N;
    splitk_reduce<<<(mn + 255) / 256, 256, 0, stream>>>(ws, ob, mn, ksplit);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  q4_gemm<Decode><<<grid, kGemmThreads, 0, stream>>>(xb, db, sc, bs, ob, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan of an (M, K) x (K, N) product of `block`-row quant
// blocks (64 or 32) on a card with `sm_count` SMs: M <= 8 takes the decode
// path with *ksplit K splits of *kb_per_split quant blocks (at most
// kGemvMaxKRows rows), enough CTAs for about two per SM; larger M the
// tiled tensor-core path (*kb_per_split 0, *ksplit 1).  The caller
// allocates ksplit*M*N floats of workspace when *ksplit > 1 and passes the
// plan to ift_q4_matmul / ift_q8_matmul / ift_q8u_matmul / ift_i4_matmul /
// ift_q3h_matmul unchanged.
int ift_matmul_plan(int M, int K, int N, int block, int sm_count,
                    int* kb_per_split, int* ksplit) {
  if (M <= 0 || K <= 0 || N <= 0 || (block != 64 && block != 32) ||
      K % block || sm_count <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 8) {
    *kb_per_split = 0;
    *ksplit = 1;
    return 0;
  }
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
  return 0;
}

// B1: Q4_B64T1 wire planes.
int ift_q4_matmul(const void* x, const void* data, const void* scale,
                  const void* base, void* out, void* workspace, int M, int K,
                  int N, int kb_per_split, int ksplit, void* stream_ptr) {
  return run_matmul<WireQ4>(x, data, scale, base, out, workspace, M, K, N,
                            kb_per_split, ksplit, stream_ptr);
}

// B1: Q8_B32T2 (signed codes, no base: `base` is not read).
int ift_q8_matmul(const void* x, const void* data, const void* scale,
                  const void* base, void* out, void* workspace, int M, int K,
                  int N, int kb_per_split, int ksplit, void* stream_ptr) {
  return run_matmul<Q8Signed>(x, data, scale, base, out, workspace, M, K, N,
                              kb_per_split, ksplit, stream_ptr);
}

// B1: Q8_B32T1 (codes 0..255, f16 scale and base).
int ift_q8u_matmul(const void* x, const void* data, const void* scale,
                   const void* base, void* out, void* workspace, int M, int K,
                   int N, int kb_per_split, int ksplit, void* stream_ptr) {
  return run_matmul<Q8Unsigned>(x, data, scale, base, out, workspace, M, K, N,
                                kb_per_split, ksplit, stream_ptr);
}

// B5: the i4 layout's data_i4p plane (signed code-8 nibbles).
int ift_i4_matmul(const void* x, const void* data, const void* scale,
                  const void* base, void* out, void* workspace, int M, int K,
                  int N, int kb_per_split, int ksplit, void* stream_ptr) {
  return run_matmul<PackedI4>(x, data, scale, base, out, workspace, M, K, N,
                              kb_per_split, ksplit, stream_ptr);
}

// B6: Q3H_B64T1 in the pair8 layout (one base-11 pair code per byte).
int ift_q3h_matmul(const void* x, const void* data, const void* scale,
                   const void* base, void* out, void* workspace, int M, int K,
                   int N, int kb_per_split, int ksplit, void* stream_ptr) {
  return run_matmul<Pair8>(x, data, scale, base, out, workspace, M, K, N,
                           kb_per_split, ksplit, stream_ptr);
}

}  // extern "C"
