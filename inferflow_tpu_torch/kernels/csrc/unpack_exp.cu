// The unpack experiments X1-X5: five ways to turn stored weight codes into
// the products of an 8-row GEMV (X5: 32 rows), for measuring which one lets
// a decode GEMV approach its byte bound.
//
// Replaces tools/exp_unpack.py's Pallas kernels run_a (:59, its
// pallas_call at :73), run_b (:90, :97), run_c (:113, :134), run_d (:151,
// :158) and run_e (:174, :183).  Each computes what its run_* computes, in
// the same types (x (8, K) bf16; scale (K/64, N) bf16, one row per 64 K
// values; out (8, N) float32):
//   X1 (unpack_a): packed (K/2, N) uint8, byte row r holding K row 2r in
//       its low nibble and 2r+1 in its high one; w = bf16(nibble * scale),
//       both nibbles shifted, masked and converted, two FMA sub-dots;
//   X2 (unpack_b): int4 codes in -8..7, stored two per byte in the same
//       order (torch has no int4 type); w = bf16(float(code) * scale);
//   X3 (unpack_c): X1's nibbles dotted raw (unscaled) over each `blk`-value
//       superblock, the partial sum multiplied after by the scale of the
//       superblock's FIRST 64-row block only (the TPU experiment's speed
//       shape, not exact dequantization; the plain version does the same);
//   X4 (unpack_d): int8 codes (K, N); w = bf16(float(code) * scale);
//   X5 (unpack_e): xq (32, K) int8 times int8 codes (K, N) with int32
//       accumulation (dp4a), then float(acc) * colscale (1, N) bf16.
//
// What bounds it on the H100: each is a GEMV over (K, N) codes with 8 (X5:
// 32) activation rows, far below the card's operations per byte: the code
// and scale bytes.  What the design does: a thread owns 4 neighbouring
// columns (one 32-bit load per code row: a warp reads 128 contiguous
// bytes), the 4 warps of a CTA split its K range (64-row chunks; X3 a
// superblock in quarters), the CTA's activations are staged once in shared
// memory, and the K ranges of the CTAs (split-K, about two CTAs per SM)
// meet in a second small kernel that adds the partial sums in a fixed
// order.  The strategies differ only in the per-code work between the load
// and the FMA (or dp4a), which is what the experiment measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;  // 32 lanes x 4 columns
constexpr int kMaxKc = 512;  // K values per CTA (activation staging)

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// The kind of code and its per-weight work.
enum Mode { kNibble = 0, kSignedNibble = 1, kRawNibble = 2, kByte = 3 };

// X1-X4: grid (N / kCols, K / kc); out partial (ksplit, 8, N) float.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
unpack_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scale, float* __restrict__ partial,
            int K, int N, int kc, int blk) {
  constexpr int M = 8;
  __shared__ float xs[M][kMaxKc];
  __shared__ float red[kWarps][M][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int k_begin = blockIdx.y * kc;
  for (int i = threadIdx.x; i < M * kc; i += kThreads) {
    const int m = i / kc, kk = i - m * kc;
    xs[m][kk] = bf(x[(size_t)m * K + k_begin + kk]);
  }
  __syncthreads();

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // a warp's chunks: 64 K values each (X3: a quarter of a superblock)
  const int chunk = MODE == kRawNibble ? blk / kWarps : 64;
  if (col0 < N) {
    for (int c0 = warp * chunk; c0 < kc; c0 += kWarps * chunk) {
      const int k0 = k_begin + c0;
      float sc[4], part[M][4];
      if (MODE == kRawNibble) {
        // the scale of the superblock's first 64-row block
        const int srow = (k0 / blk) * (blk / 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[j] = bf(scale[(size_t)srow * N + col0 + j]);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
      }
      if (MODE == kByte) {
        for (int k = 0; k < chunk; ++k) {
          if (k % 64 == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[j] = bf(scale[(size_t)((k0 + k) / 64) * N + col0 + j]);
          }
          const uint32_t w4 = __ldg(reinterpret_cast<const uint32_t*>(
              codes + (size_t)(k0 + k) * N + col0));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float q = float(int8_t((w4 >> (8 * j)) & 0xFFu));
            const float w = round_bf16(q * sc[j]);
#pragma unroll
            for (int m = 0; m < M; ++m) acc[m][j] = fmaf(xs[m][c0 + k], w, acc[m][j]);
          }
        }
      } else {
        for (int r = 0; r < chunk / 2; ++r) {  // byte rows: K rows 2r, 2r+1
          const int k = 2 * r;
          if (MODE != kRawNibble && k % 64 == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[j] = bf(scale[(size_t)((k0 + k) / 64) * N + col0 + j]);
          }
          const uint32_t w4 = __ldg(reinterpret_cast<const uint32_t*>(
              codes + (size_t)((k0 + k) / 2) * N + col0));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = (w4 >> (8 * j)) & 0xFFu;
            float lo, hi;
            if (MODE == kSignedNibble) {
              lo = float(int((b & 0xFu) ^ 8u) - 8);
              hi = float(int((b >> 4) ^ 8u) - 8);
            } else {
              lo = float(b & 0xFu);
              hi = float(b >> 4);
            }
            if (MODE == kRawNibble) {
#pragma unroll
              for (int m = 0; m < M; ++m) {
                part[m][j] = fmaf(xs[m][c0 + k], lo, part[m][j]);
                part[m][j] = fmaf(xs[m][c0 + k + 1], hi, part[m][j]);
              }
            } else {
              const float wl = round_bf16(lo * sc[j]), wh = round_bf16(hi * sc[j]);
#pragma unroll
              for (int m = 0; m < M; ++m) {
                acc[m][j] = fmaf(xs[m][c0 + k], wl, acc[m][j]);
                acc[m][j] = fmaf(xs[m][c0 + k + 1], wh, acc[m][j]);
              }
            }
          }
        }
      }
      if (MODE == kRawNibble) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(part[m][j], sc[j], acc[m][j]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kCols; i += kThreads) {
    const int m = i / kCols, c = i - m * kCols;
    const int col = blockIdx.x * kCols + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    partial[((size_t)blockIdx.y * M + m) * N + col] = s;
  }
}

// X5: grid (N / kCols, K / kc); xq (32, K) int8, codes (K, N) int8; out
// partial (ksplit, 32, N) int32.  Four code rows of 4 columns are loaded as
// four words and transposed (byte permutes) into one word per column, the
// 4 K values dp4a takes.
__global__ void __launch_bounds__(kThreads)
unpack_dp4a(const int8_t* __restrict__ xq, const int8_t* __restrict__ codes,
            int* __restrict__ partial, int K, int N, int kc) {
  constexpr int M = 32;
  __shared__ int xs[M][kMaxKc / 4];
  __shared__ int red[kWarps][M][kCols / 4];  // reused per 4-column slice
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int k_begin = blockIdx.y * kc;
  const int kw = kc / 4;
  for (int i = threadIdx.x; i < M * kw; i += kThreads) {
    const int m = i / kw, w = i - m * kw;
    xs[m][w] = *reinterpret_cast<const int*>(xq + (size_t)m * K + k_begin + 4 * w);
  }
  __syncthreads();

  int acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  if (col0 < N) {
    for (int c0 = warp * 64; c0 < kc; c0 += kWarps * 64) {
      for (int k = 0; k < 64; k += 4) {
        const int8_t* p = codes + (size_t)(k_begin + c0 + k) * N + col0;
        const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
        const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(p + N));
        const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * (size_t)N));
        const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * (size_t)N));
        // column j's 4 K values: byte j of r0..r3
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
        const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
        const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
        int cw[4];
        cw[0] = int(__byte_perm(lo01, lo23, 0x5410));
        cw[1] = int(__byte_perm(lo01, lo23, 0x7632));
        cw[2] = int(__byte_perm(hi01, hi23, 0x5410));
        cw[3] = int(__byte_perm(hi01, hi23, 0x7632));
        const int xw = (c0 + k) / 4;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int xv = xs[m][xw];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xv, cw[j], acc[m][j]);
        }
      }
    }
  }

  // the warps' sums, one column of the 4 at a time (shared memory for a
  // quarter of the tile)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp][m][lane] = acc[m][j];
    __syncthreads();
    for (int i = threadIdx.x; i < M * 32; i += kThreads) {
      const int m = i / 32, l = i % 32;
      const int col = blockIdx.x * kCols + l * 4 + j;
      if (col < N) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][m][l];
        partial[((size_t)blockIdx.y * M + m) * N + col] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void reduce_float(const float* __restrict__ partial, float* __restrict__ out,
                             int mn, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * mn + i];
  out[i] = s;
}

__global__ void reduce_int_scale(const int* __restrict__ partial,
                                 const __nv_bfloat16* __restrict__ colscale,
                                 float* __restrict__ out, int M, int N, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  int s = 0;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * M * N + i];
  out[i] = float(s) * bf(colscale[i % N]);
}

bool bad_shape(int K, int N, int kc, int unit) {
  return K <= 0 || N <= 0 || N % 4 || kc <= 0 || kc > kMaxKc || kc % unit ||
         K % kc;
}

template <int MODE>
int run_unpack(const void* x, const void* codes, const void* scale, void* partial,
               void* out, int K, int N, int kc, int blk, void* stream_ptr) {
  const int unit = MODE == kRawNibble ? blk : 64;
  if (bad_shape(K, N, kc, unit) ||
      (MODE == kRawNibble && (blk < 128 || blk % 128 || blk > kMaxKc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ksplit = K / kc;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  unpack_gemv<MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(partial), K, N,
      kc, blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = 8 * N;
  reduce_float<<<(mn + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), mn, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X1-X4: x (8, K) bf16, codes (K/2, N) uint8 (X4: (K, N) int8), scale
// (K/64, N) bf16 -> out (8, N) float; `partial` holds (K/kc, 8, N) floats;
// each CTA takes kc K values (a multiple of 64, X3: of blk, at most 512).
int ift_unpack_a(const void* x, const void* packed, const void* scale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  return run_unpack<kNibble>(x, packed, scale, partial, out, K, N, kc, 64, stream);
}
int ift_unpack_b(const void* x, const void* codes4, const void* scale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  return run_unpack<kSignedNibble>(x, codes4, scale, partial, out, K, N, kc, 64, stream);
}
int ift_unpack_c(const void* x, const void* packed, const void* scale, void* partial,
                 void* out, int K, int N, int kc, int blk, void* stream) {
  return run_unpack<kRawNibble>(x, packed, scale, partial, out, K, N, kc, blk, stream);
}
int ift_unpack_d(const void* x, const void* codes8, const void* scale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  return run_unpack<kByte>(x, codes8, scale, partial, out, K, N, kc, 64, stream);
}

// X5: xq (32, K) int8, codes (K, N) int8, colscale (1, N) bf16 -> out
// (32, N) float; `partial` holds (K/kc, 32, N) int32.
int ift_unpack_e(const void* xq, const void* codes8, const void* colscale, void* partial,
                 void* out, int K, int N, int kc, void* stream) {
  if (bad_shape(K, N, kc, 64) || K % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksplit = K / kc;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  unpack_dp4a<<<grid, kThreads, 0, st>>>(static_cast<const int8_t*>(xq),
                                         static_cast<const int8_t*>(codes8),
                                         static_cast<int*>(partial), K, N, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = 32 * N;
  reduce_int_scale<<<(mn + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(partial), static_cast<const __nv_bfloat16*>(colscale),
      static_cast<float*>(out), 32, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
