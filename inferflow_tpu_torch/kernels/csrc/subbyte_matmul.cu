// Dequantize-matmul for the sub-byte block formats in their wire planes:
// y = x @ dequant(W).
//
// Kernel B1 replaces inferflow_tpu/kernels/dequant_matmul.py
// `_make_fast_kernel` (its pallas_call at :505, public entry
// `quantized_matmul` at :643) for every block format of quant/formats.py
// with codes under 8 bits other than Q4_B64T1 (dequant_matmul.cu) and Q3H
// (B6's pair8 plane):
//   format           planes (bits)          block  metadata
//   Q6_B64T1         data 4, data_h 2       64     f16 scale + base
//   Q5_B64T1         data 4, data_h 1       64     f16
//   Q5_B32T1         data 4 split, data_h 1 32     f16
//   Q4_B32T1A / B    data 4                 32     f16 (B: mid base)
//   Q4_B32T2         data 4                 32     f32 (decoded u8)
//   Q4_B16           data 4                 16     f32 (decoded u8)
//   Q3_B32T1A / B    data 2, data_h 1       32     f16
//   Q2_B32T1A / B    data 2                 32     f16
// The code of a K row is the low plane's value OR the high plane's shifted
// up by the low plane's bits, and the weight is w = bf16(code*scale +
// base), two rounded float32 operations: codec_torch.dequantize's weight
// bit for bit, so kernel and plain version differ in summation order only.
// The TPU kernel instead dots each plane (and each value of a byte) apart,
// with the scale rounded to bf16 and multiplied by the plane's 2^shift,
// because its vector unit could not interleave K; the port keeps the
// codec's weights (ROADMAP section C).  The A and B variants differ only in
// how the quantizer picks the stored base, so they share a policy.
//
// The kernels are dequant_matmul.cuh's, on the `Wire` policy of each
// geometry: a quant block is 4 to 32 byte rows per plane (a 1-bit plane's
// byte covers 8 K rows); the GEMV (`dq_gemv_mma`) streams the planes' byte
// rows 16 K rows at a time (Q5_B32T1's split half: a whole block) through
// each warp's ring and decodes them for the tensor cores, and the prefill
// tile steps K one quant block at a time (16 rows for Q4_B16: one WMMA
// step).
//
// What bounds it on the H100: at decode (M <= 8) the bytes of the planes
// and metadata, 3 (Q2) to 8 (Q4_B16, whose f32 metadata is 4 of them)
// bits per weight; at prefill the bf16 tensor-core work.

#include "dequant_matmul.cuh"

namespace {

using Q6 = Wire<64, 4, false, 2, __half>;        // Q6_B64T1
using Q5 = Wire<64, 4, false, 1, __half>;        // Q5_B64T1
using Q5Split = Wire<32, 4, true, 1, __half>;    // Q5_B32T1
using Q4B32 = Wire<32, 4, false, 0, __half>;     // Q4_B32T1A / B
using Q4B32F32 = Wire<32, 4, false, 0, float>;   // Q4_B32T2
using Q4B16F32 = Wire<16, 4, false, 0, float>;   // Q4_B16
using Q3 = Wire<32, 2, false, 1, __half>;        // Q3_B32T1A / B
using Q2 = Wire<32, 2, false, 0, __half>;        // Q2_B32T1A / B

}  // namespace

extern "C" {

const char* ift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One entry per geometry (IFT_MATMUL_ENTRY's signature, with its plan
// <entry>_plan): `data` is the low plane, `data_h` the high one (not read
// by the one-plane formats);
// scale and base are f16, or f32 for Q4_B32T2 and Q4_B16.
IFT_MATMUL_ENTRY(ift_q6_matmul, Q6)
IFT_MATMUL_ENTRY(ift_q5_matmul, Q5)
IFT_MATMUL_ENTRY(ift_q5s_matmul, Q5Split)
IFT_MATMUL_ENTRY(ift_q4b32_matmul, Q4B32)
IFT_MATMUL_ENTRY(ift_q4b32f_matmul, Q4B32F32)
IFT_MATMUL_ENTRY(ift_q4b16f_matmul, Q4B16F32)
IFT_MATMUL_ENTRY(ift_q3_matmul, Q3)
IFT_MATMUL_ENTRY(ift_q2_matmul, Q2)

}  // extern "C"
