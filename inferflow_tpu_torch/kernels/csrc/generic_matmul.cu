// Dequantize-matmul over a block format's wire planes, decoded from a plane
// list given at run time: y = x @ dequant(W).
//
// Kernel B6 replaces inferflow_tpu/kernels/dequant_matmul.py `_make_kernel`
// (:244, its pallas_call at :573) in the two modes dequant_matmul.cu does
// not take:
//   - the wire mode (ift_q3h_wire_matmul): Q3H_B64T1 in its three wire
//     planes (`data` 4 bits, `data_m` 2, `data_h` 1 of each base-11 pair
//     code, over K/2 pair codes: codec_torch.from_np(..., fast_layout=False)
//     or pair8_to_wire).  The planes are OR-combined into the 7-bit pair
//     code b, which splits into v0 = b mod 11 (K row 2j) and v1 = b div 11
//     (K row 2j+1); the weight is bf16(v*scale + base) and v0, v1 meet the
//     even and odd activations;
//   - the non-pair branch (ift_generic_matmul): any block format but Q3H
//     in its wire planes (bits, layout, shift, signedness, base or none,
//     block of 16, 32 or 64 rows, f16 or f32 metadata, all run-time
//     arguments): the code is the OR of the planes' values, each shifted up
//     by the bits of the planes before it, reinterpreted as int8 when the
//     format is signed, and the weight is bf16(q*scale (+ base)).  Like the
//     TPU kernel this is the format-generic path: B1's per-format
//     instantiations (dequant_matmul.cu, subbyte_matmul.cu) serve the
//     package's products; this one serves kernel_bench's --b6 cases.
// Each weight is two rounded float32 operations (no fused multiply-add),
// rounded once to bf16: codec_torch.dequantize's weight bit for bit, so a
// kernel and its plain version differ in summation order only.
//
// What bounds it on the H100: at decode (M <= 8) the bytes of the planes
// and metadata (4.5 bits per weight for Q3H's wire planes); at prefill the
// bf16 tensor-core work.  What the design does: the decode GEMV and the
// prefill WMMA tile of dequant_matmul.cuh (its split-K plan, its reduce
// kernel and its tile sizes), with the code of each K position rebuilt from
// every plane's byte (one 32-bit load of 4 columns per plane in the GEMV,
// one 16-byte load of 16 columns per plane in the tile).  The plane list
// is read at run time, so the inner loop is not unrolled over a block as
// B1's is: a generic kernel, slower than B1's per-format ones.

#include "dequant_matmul.cuh"

namespace {

// A format's wire planes and block metadata, as run-time values.
struct GenericFormat {
  const uint8_t* plane[3];
  int bits[3];   // 1, 2, 4 or 8
  int split[3];  // 1: the split-half nibble layout (Q5_B32T1's low plane)
  int rows[3];   // byte rows of each plane per quant block
  int nplanes;
  int block;     // K rows per quant block: 16, 32 or 64
  int codes;     // codes per quant block: block, or block / 2 for pairs
  int is_signed, has_base, meta_f32;
};

// Byte row and bit offset of code c (of a quant block) in plane p.
__device__ __forceinline__ void locate(const GenericFormat& f, int p, int c,
                                       int* row, int* shift) {
  if (f.split[p]) {
    const int half = f.codes / 2;
    *row = c % half;
    *shift = (c / half) * 4;
  } else {
    const int per = 8 / f.bits[p];
    *row = c / per;
    *shift = (c % per) * f.bits[p];
  }
}

// The codes at position c of quant block kb for the 4 columns col..col+3.
__device__ __forceinline__ void codes4(const GenericFormat& f, int kb, int c,
                                       int col, int N, uint32_t code[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) code[j] = 0;
  int up = 0;
  for (int p = 0; p < f.nplanes; ++p) {
    int r, s;
    locate(f, p, c, &r, &s);
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
        f.plane[p] + ((size_t)kb * f.rows[p] + r) * N + col));
    const uint32_t mask = (1u << f.bits[p]) - 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) code[j] |= (((w >> (8 * j)) >> s) & mask) << up;
    up += f.bits[p];
  }
}

__device__ __forceinline__ float meta_at(const void* p, size_t i, int f32) {
  return f32 ? static_cast<const float*>(p)[i]
             : __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void meta4(const void* p, size_t i, int f32,
                                      float v[4]) {
  if (f32)
    load4(static_cast<const float*>(p) + i, v);
  else
    load4(static_cast<const __half*>(p) + i, v);
}

// A non-pair code as the multiplier: the int8 reinterpretation
// code - ((code >> 7) << 8) for a signed format.
__device__ __forceinline__ float code_value(uint32_t code, int is_signed) {
  return is_signed ? float(int(code) - int((code >> 7) << 8)) : float(code);
}

__device__ __forceinline__ float weight(float q, float sc, float bs,
                                        int has_base) {
  const float w = __fmul_rn(q, sc);
  return has_base ? __fadd_rn(w, bs) : w;
}

// ---------------------------------------------------------------- decode
template <bool kPair, int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
gen_gemv(const __nv_bfloat16* __restrict__ x, const GenericFormat f,
         const void* __restrict__ scale, const void* __restrict__ base,
         float* __restrict__ partial, __nv_bfloat16* __restrict__ out, int K,
         int N, int kb_per_split, int ksplit) {
  __shared__ float xs[M][kGemvMaxKRows];
  __shared__ float red[kGemvWarps][M][kGemvCols];

  const int block = f.block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kGemvCols + lane * 4;
  const int split = blockIdx.y;
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(kb_begin + kb_per_split, K / block);
  const int k_begin = kb_begin * block;
  const int k_len = max(kb_end - kb_begin, 0) * block;

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
      float sc[4], bs[4] = {0.f, 0.f, 0.f, 0.f};
      meta4(scale, (size_t)kb * N + col0, f.meta_f32, sc);
      if (f.has_base) meta4(base, (size_t)kb * N + col0, f.meta_f32, bs);
      const int kk0 = (kb - kb_begin) * block;
      for (int c = 0; c < f.codes; ++c) {
        uint32_t code[4];
        codes4(f, kb, c, col0, N, code);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kPair) {
            const uint32_t v1 = code[j] / 11u;
            const float w0 =
                round_bf16(weight(float(code[j] - 11u * v1), sc[j], bs[j], 1));
            const float w1 = round_bf16(weight(float(v1), sc[j], bs[j], 1));
#pragma unroll
            for (int m = 0; m < M; ++m) {
              acc[m][j] = fmaf(xs[m][kk0 + 2 * c], w0, acc[m][j]);
              acc[m][j] = fmaf(xs[m][kk0 + 2 * c + 1], w1, acc[m][j]);
            }
          } else {
            const float w = round_bf16(weight(code_value(code[j], f.is_signed),
                                              sc[j], bs[j], f.has_base));
#pragma unroll
            for (int m = 0; m < M; ++m)
              acc[m][j] = fmaf(xs[m][kk0 + c], w, acc[m][j]);
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

// --------------------------------------------------------------- prefill
// dq_gemm's 64x64 tile with the K step one quant block (16 to 64 rows: the
// shared memory is sized for 64).
template <bool kPair>
__global__ void __launch_bounds__(kGemmThreads)
gen_gemm(const __nv_bfloat16* __restrict__ x, const GenericFormat f,
         const void* __restrict__ scale, const void* __restrict__ base,
         __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int kLdx = GemmSmem<64>::kLdx;
  __shared__ __align__(128) unsigned char smem[GemmSmem<64>::kBytes];
  __shared__ float sc_s[kBN], bs_s[kBN];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + kBM * kLdx;
  float* cs = reinterpret_cast<float*>(smem);

  const int block = f.block;
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

  for (int k0 = 0; k0 < K; k0 += block) {
    const int kb = k0 / block;
    if (tid < kBN) {
      const int col = n0 + tid;
      sc_s[tid] = col < N ? meta_at(scale, (size_t)kb * N + col, f.meta_f32) : 0.f;
      bs_s[tid] = col < N && f.has_base
                      ? meta_at(base, (size_t)kb * N + col, f.meta_f32)
                      : 0.f;
    }
    // x tile: 64 rows x `block` bf16, 16-byte chunks (rows past M: zeros)
    for (int c = tid; c < kBM * (block / 8); c += kGemmThreads) {
      const int row = c / (block / 8);
      const int ch = c % (block / 8);
      const int gm = m0 + row;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + ch * 8);
      *reinterpret_cast<uint4*>(xs + row * kLdx + ch * 8) = v;
    }
    __syncthreads();  // sc_s / bs_s visible
    // W tile: each item one code position of a 16-column run (one K row,
    // two for a pair code), its byte of every plane read as 16-byte loads
    for (int it = tid; it < f.codes * (kBN / 16); it += kGemmThreads) {
      const int c = it / (kBN / 16);
      const int c0 = (it % (kBN / 16)) * 16;
      const int col = n0 + c0;
      uint32_t code[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) code[i] = 0;
      if (col < N) {  // N % 16 == 0: the 16-column run is in range
        int up = 0;
        for (int p = 0; p < f.nplanes; ++p) {
          int r, s;
          locate(f, p, c, &r, &s);
          const uint4 v = *reinterpret_cast<const uint4*>(
              f.plane[p] + ((size_t)kb * f.rows[p] + r) * N + col);
          const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
          const uint32_t mask = (1u << f.bits[p]) - 1u;
#pragma unroll
          for (int i = 0; i < 16; ++i) code[i] |= ((uint32_t(b[i]) >> s) & mask) << up;
          up += f.bits[p];
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float sc = sc_s[c0 + i], bs = bs_s[c0 + i];
        if constexpr (kPair) {
          const uint32_t v1 = code[i] / 11u;
          ws[(2 * c) * kLdw + c0 + i] = __float2bfloat16_rn(
              weight(float(code[i] - 11u * v1), sc, bs, 1));
          ws[(2 * c + 1) * kLdw + c0 + i] =
              __float2bfloat16_rn(weight(float(v1), sc, bs, 1));
        } else {
          ws[c * kLdw + c0 + i] = __float2bfloat16_rn(
              weight(code_value(code[i], f.is_signed), sc, bs, f.has_base));
        }
      }
    }
    __syncthreads();
    for (int kk = 0; kk < block; kk += 16) {
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

template <bool kPair, int M>
void launch_gen_gemv(const __nv_bfloat16* x, const GenericFormat& f,
                     const void* scale, const void* base, float* partial,
                     __nv_bfloat16* out, int K, int N, int kb_per_split,
                     int ksplit, cudaStream_t stream) {
  dim3 grid((N + kGemvCols - 1) / kGemvCols, ksplit);
  gen_gemv<kPair, M><<<grid, kGemvWarps * 32, 0, stream>>>(
      x, f, scale, base, partial, out, K, N, kb_per_split, ksplit);
}

// y = x @ dequant(W) for the format f, with a plan from plan_matmul (the
// checks of run_matmul in dequant_matmul.cuh, plus the plane list's).
template <bool kPair>
int run_generic(const void* x, const GenericFormat& f, const void* scale,
                const void* base, void* out, void* workspace, int M, int K,
                int N, int kb_per_split, int ksplit, void* stream_ptr) {
  const int block = f.block;
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 || scale == nullptr ||
      (block != 16 && block != 32 && block != 64) || K % block ||
      f.nplanes < 1 || f.nplanes > 3 || (f.has_base && base == nullptr) ||
      f.codes != (kPair ? block / 2 : block))
    return static_cast<int>(cudaErrorInvalidValue);
  int code_bits = 0;
  for (int p = 0; p < f.nplanes; ++p) {
    const int b = f.bits[p];
    if (f.plane[p] == nullptr || (b != 1 && b != 2 && b != 4 && b != 8) ||
        (f.split[p] && (b != 4 || f.codes % 2)) || f.codes % (8 / b) ||
        f.rows[p] != f.codes * b / 8)
      return static_cast<int>(cudaErrorInvalidValue);
    code_bits += b;
  }
  if (code_bits > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8) {
    const int nkb = K / block;
    if (kb_per_split < 1 || kb_per_split * block > kGemvMaxKRows ||
        ksplit < 1 || kb_per_split * ksplit < nkb ||
        kb_per_split * (ksplit - 1) >= nkb ||
        (ksplit > 1 && workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* ws = static_cast<float*>(workspace);
  if (M <= 8) {
    switch (M) {
      case 1: launch_gen_gemv<kPair, 1>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 2: launch_gen_gemv<kPair, 2>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 3: launch_gen_gemv<kPair, 3>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 4: launch_gen_gemv<kPair, 4>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 5: launch_gen_gemv<kPair, 5>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 6: launch_gen_gemv<kPair, 6>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      case 7: launch_gen_gemv<kPair, 7>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
      default: launch_gen_gemv<kPair, 8>(xb, f, scale, base, ws, ob, K, N, kb_per_split, ksplit, stream); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
    const int mn = M * N;
    splitk_reduce<<<(mn + 255) / 256, 256, 0, stream>>>(ws, ob, mn, ksplit);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gen_gemm<kPair><<<grid, kGemmThreads, 0, stream>>>(xb, f, scale, base, ob, M,
                                                      K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// plan_matmul (dequant_matmul.cuh) for the two entries below.
int ift_matmul_plan(int M, int K, int N, int block, int sm_count,
                    int* kb_per_split, int* ksplit) {
  return plan_matmul(M, K, N, block, sm_count, kb_per_split, ksplit);
}

// B6's non-pair branch.  Planes 0..nplanes-1 (null past nplanes) in the
// order of the format's plane list, plane p of bits[p] bits (split0: plane
// 0 in the split-half nibble layout); `block` K rows per quant block;
// flags: 1 signed codes (int8 reinterpret), 2 a base plane, 4 f32
// metadata (else f16).  x (M, K) bf16 -> out (M, N) bf16.
int ift_generic_matmul(const void* x, const void* plane0, const void* plane1,
                       const void* plane2, const void* scale, const void* base,
                       void* out, void* workspace, int M, int K, int N,
                       int kb_per_split, int ksplit, int nplanes, int bits0,
                       int bits1, int bits2, int split0, int block, int flags,
                       void* stream) {
  GenericFormat f{};
  const void* planes[3] = {plane0, plane1, plane2};
  const int bits[3] = {bits0, bits1, bits2};
  f.nplanes = nplanes;
  f.block = block;
  f.codes = block;
  for (int p = 0; p < 3 && p < nplanes; ++p) {
    f.plane[p] = static_cast<const uint8_t*>(planes[p]);
    f.bits[p] = bits[p];
    f.split[p] = p == 0 ? split0 : 0;
    f.rows[p] = bits[p] > 0 ? block * bits[p] / 8 : 0;
  }
  f.is_signed = flags & 1;
  f.has_base = (flags >> 1) & 1;
  f.meta_f32 = (flags >> 2) & 1;
  return run_generic<false>(x, f, scale, base, out, workspace, M, K, N,
                            kb_per_split, ksplit, stream);
}

// B6's wire mode: Q3H_B64T1's planes data (4 bits), data_m (2), data_h
// (1) over K/2 pair codes, f16 scale and base.  x (M, K) bf16 -> out
// (M, N) bf16.
int ift_q3h_wire_matmul(const void* x, const void* data, const void* data_m,
                        const void* data_h, const void* scale, const void* base,
                        void* out, void* workspace, int M, int K, int N,
                        int kb_per_split, int ksplit, void* stream) {
  GenericFormat f{};
  const void* planes[3] = {data, data_m, data_h};
  const int bits[3] = {4, 2, 1};
  f.nplanes = 3;
  f.block = 64;
  f.codes = 32;
  for (int p = 0; p < 3; ++p) {
    f.plane[p] = static_cast<const uint8_t*>(planes[p]);
    f.bits[p] = bits[p];
    f.rows[p] = f.codes * bits[p] / 8;
  }
  f.has_base = 1;
  return run_generic<true>(x, f, scale, base, out, workspace, M, K, N,
                           kb_per_split, ksplit, stream);
}

}  // extern "C"
