// The dequantize-matmul kernels, y = x @ dequant(W), templated on how a
// block of W decodes; shared by dequant_matmul.cu (B1 for Q4_B64T1 and
// the Q8 formats, B5, B6) and subbyte_matmul.cu (B1 for the sub-byte wire
// formats), each of which instantiates its own policies.
//
// Operands (row-major):
//   x       (M, K)    bf16 activations
//   data    (K*b0/8, N) uint8: plane 0, the policy's low code bits
//   data_h  (K*b1/8, N) uint8: plane 1, the high code bits (two-plane
//                      formats only; null otherwise)
//   scale   (K/B, N)  per-block scales, f16 or f32 (the policy's Meta)
//   base    (K/B, N)  per-block bases of the same type; null for a format
//                     without one
//   out     (M, N)    bf16
// Each weight is value*scale + offset as two rounded float32 operations
// (no fused multiply-add), rounded to bf16, and the products accumulate in
// float32: the codec's weights (codec_torch.dequantize), so a kernel and
// its plain version differ in summation order only.  Pad blocks of a
// K-padded tensor have scale 0 and base 0 and add exact zeros.
//
// A policy D describes a quant block of D::kBlock K rows stored in one or
// two byte planes, D::kRows0 and D::kRows1 byte rows of each per block
// (kRows1 = 0 for one plane):
//   row(p, k)          the byte row of plane p (within the block) that holds
//                      K row k of the block;
//   value(b0, b1, k)   K row k's multiplier from those two bytes;
//   offset(sc, base)   the block's additive term; kBase: whether the
//                      format stores a base (read only then);
//   Meta               the type of the scale and base planes.
//
// What the design does about the card (every policy):
//   - decode (`dq_gemv`, M <= 8): neighbouring threads own neighbouring
//     4-column groups, so a warp reads 128 contiguous bytes of a plane row
//     (one 32-bit load per thread) and the block's scale/base for its 128
//     columns; a thread loads every plane row of a quant block before
//     decoding any (memory-level parallelism); K is split over
//     the warps of a CTA and over CTAs (about two CTAs per SM, from the SM
//     count the caller reads off the device: `plan_matmul`), with the x
//     slice of the CTA (at most kGemvMaxKRows rows) staged once in shared
//     memory and one float32 accumulator per (row, column) in registers;
//     the split-K partial sums are added in a fixed order by a second small
//     kernel (deterministic).
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
  static constexpr bool kBase = true;
  __host__ __device__ static constexpr int row(int p, int k) {
    return p == 0 ? (kSplit ? k % (kBlock / 2) : k / kPer0) : k / kPer1;
  }
  __device__ static float offset(float, float base) { return base; }
  __device__ static float value(uint32_t b0, uint32_t b1, int k) {
    const int s0 = kSplit ? (k / (kBlock / 2)) * 4 : (k % kPer0) * kBits0;
    uint32_t code = (b0 >> s0) & ((1u << kBits0) - 1u);
    if constexpr (kBits1 > 0)
      code |= ((b1 >> ((k % kPer1) * kBits1)) & ((1u << kBits1) - 1u))
              << kBits0;
    return float(code);
  }
};

template <class D>
__device__ __forceinline__ float dequant(float value, float scale, float offset) {
  if constexpr (!D::kBase) return __fmul_rn(value, scale);
  return __fadd_rn(__fmul_rn(value, scale), offset);
}

// ---------------------------------------------------------------- decode
constexpr int kGemvWarps = 4;
constexpr int kGemvCols = 128;  // 32 lanes x 4 columns
constexpr int kGemvMaxKRows = 512;  // K rows per CTA (x staging)

template <class D, int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
dq_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ data0,
        const uint8_t* __restrict__ data1,
        const typename D::Meta* __restrict__ scale,
        const typename D::Meta* __restrict__ base, float* __restrict__ partial,
        __nv_bfloat16* __restrict__ out, int K, int N, int kb_per_split,
        int ksplit) {
  constexpr int kBlock = D::kBlock, R0 = D::kRows0, R1 = D::kRows1;
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
      uint32_t w0[R0], w1[R1 > 0 ? R1 : 1];
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
      const int kk0 = (kb - kb_begin) * kBlock;
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = (w0[D::row(0, k)] >> (8 * j)) & 0xFFu;
          uint32_t b1 = 0;
          if constexpr (R1 > 0) b1 = (w1[D::row(1, k)] >> (8 * j)) & 0xFFu;
          const float w =
              round_bf16(dequant<D>(D::value(b0, b1, k), sc[j], off[j]));
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
        const uint8_t* __restrict__ data1,
        const typename D::Meta* __restrict__ scale,
        const typename D::Meta* __restrict__ base,
        __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int kBK = D::kBlock, R0 = D::kRows0, R1 = D::kRows1;
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
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = make_uint4(0, 0, 0, 0);
      if (col < N) {  // N % 16 == 0: the 16-column run is in range
        v0 = *reinterpret_cast<const uint4*>(
            data0 + ((size_t)kb * R0 + D::row(0, k)) * N + col);
        if constexpr (R1 > 0)
          v1 = *reinterpret_cast<const uint4*>(
              data1 + ((size_t)kb * R1 + D::row(1, k)) * N + col);
      }
      const uint8_t* b0 = reinterpret_cast<const uint8_t*>(&v0);
      const uint8_t* b1 = reinterpret_cast<const uint8_t*>(&v1);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ws[k * kLdw + c0 + i] = __float2bfloat16_rn(dequant<D>(
            D::value(b0[i], b1[i], k), sc_s[c0 + i], off_s[c0 + i]));
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

template <class D, int M>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* data0,
                 const uint8_t* data1, const typename D::Meta* scale,
                 const typename D::Meta* base, float* partial,
                 __nv_bfloat16* out, int K, int N, int kb_per_split,
                 int ksplit, cudaStream_t stream) {
  dim3 grid((N + kGemvCols - 1) / kGemvCols, ksplit);
  dq_gemv<D, M><<<grid, kGemvWarps * 32, 0, stream>>>(
      x, data0, data1, scale, base, partial, out, K, N, kb_per_split, ksplit);
}

// y = x @ dequant(W) with a plan from plan_matmul; a decode plan that does
// not cover K exactly once, or that overflows the x staging buffer, is
// refused with cudaErrorInvalidValue, as is a missing base or high plane
// for a format that has one.
template <class D>
int run_matmul(const void* x, const void* data0, const void* data1,
               const void* scale, const void* base, void* out,
               void* workspace, int M, int K, int N, int kb_per_split,
               int ksplit, void* stream_ptr) {
  constexpr int kBlock = D::kBlock;
  if (M <= 0 || K <= 0 || K % kBlock || N <= 0 || N % 16 ||
      (D::kBase && base == nullptr) || (D::kRows1 > 0 && data1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8) {
    const int nkb = K / kBlock;
    if (kb_per_split < 1 || kb_per_split * kBlock > kGemvMaxKRows || ksplit < 1 ||
        kb_per_split * ksplit < nkb || kb_per_split * (ksplit - 1) >= nkb ||
        (ksplit > 1 && workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  using Meta = typename D::Meta;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* d0 = static_cast<const uint8_t*>(data0);
  auto* d1 = static_cast<const uint8_t*>(data1);
  auto* sc = static_cast<const Meta*>(scale);
  auto* bs = static_cast<const Meta*>(base);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* ws = static_cast<float*>(workspace);
  if (M <= 8) {
    switch (M) {
      case 1: launch_gemv<D, 1>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 2: launch_gemv<D, 2>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 3: launch_gemv<D, 3>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 4: launch_gemv<D, 4>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 5: launch_gemv<D, 5>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 6: launch_gemv<D, 6>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 7: launch_gemv<D, 7>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      default: launch_gemv<D, 8>(xb, d0, d1, sc, bs, ws, ob, K, N, kb_per_split, ksplit, stream); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
    const int mn = M * N;
    splitk_reduce<<<(mn + 255) / 256, 256, 0, stream>>>(ws, ob, mn, ksplit);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dq_gemm<D><<<grid, kGemmThreads, 0, stream>>>(xb, d0, d1, sc, bs, ob, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of an (M, K) x (K, N) product of `block`-row quant
// blocks (64, 32 or 16) on a card with `sm_count` SMs: M <= 8 takes the
// decode path with *ksplit K splits of *kb_per_split quant blocks (at most
// kGemvMaxKRows rows), enough CTAs for about two per SM; larger M the
// tiled tensor-core path (*kb_per_split 0, *ksplit 1).  The caller
// allocates ksplit*M*N floats of workspace when *ksplit > 1 and passes the
// plan to the matmul entry unchanged.
int plan_matmul(int M, int K, int N, int block, int sm_count,
                int* kb_per_split, int* ksplit) {
  if (M <= 0 || K <= 0 || N <= 0 ||
      (block != 64 && block != 32 && block != 16) || K % block ||
      sm_count <= 0)
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

}  // namespace

// A C entry `name` running run_matmul<D>, inside an extern "C" block:
// (x, data, data_h, scale, base, out, workspace, M, K, N, kb_per_split,
// ksplit, stream) -> the launch's cudaGetLastError().
#define IFT_MATMUL_ENTRY(name, D)                                           \
  int name(const void* x, const void* data, const void* data_h,             \
           const void* scale, const void* base, void* out, void* workspace, \
           int M, int K, int N, int kb_per_split, int ksplit,               \
           void* stream_ptr) {                                              \
    return run_matmul<D>(x, data, data_h, scale, base, out, workspace, M, K, \
                         N, kb_per_split, ksplit, stream_ptr);              \
  }
