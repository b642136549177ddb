"""Quantization format registry (a copy of inferflow_tpu/quant/formats.py,
kept so that the PyTorch package imports nothing of the JAX one).

Mirrors the block formats of the reference engine (reference:
src/common/quant_types.h, src/tensor/tensor_common.h:15-42) with a
struct-of-arrays layout: instead of interleaved per-block C structs, each
quantized 2-D tensor is stored as separate *bit-plane* arrays plus fp16
scale/base planes.  Within each plane, values are packed consecutively along
the contraction (K) axis, low bits first — which is byte-for-byte the same
ordering the reference uses for its `data` / `data_m` / `data_h` members, so
the planes here are bit-identical to the reference wire format, merely
de-interleaved (reference: src/common/quantization.h).

Logical weight shape convention: (K, N) = (in_features, out_features), with
quantization blocks running along K (the reference quantizes weight rows,
blocks along the input dimension; see src/tensor/device_tensor_util.cu).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """One bit-plane of a quantized block format."""

    name: str  # 'data' | 'data_m' | 'data_h'
    bits: int  # bits per value (or per value-pair for pair-coded formats)
    layout: str = "consecutive"  # 'consecutive' | 'split_half' (Q5_B32T1 nibbles)


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """A block quantization format.

    rounding:
      'half_up'   -> q = trunc(qf + 0.5)        (reference A-variants)
      'round'     -> q = round-half-away-0      (reference Q8_B32T2)
      'trunc_eps' -> q = trunc(qf + 0.0001)     (reference B-variants)
    base_kind:
      'min'  -> base = block min
      'mid'  -> base = min + 0.5*scale (B-variants), scale = range / 2^bits
      'zero' -> symmetric, no base (Q8_B32T2)
    meta:
      'f16' -> fp16 scale/base planes
      'u8'  -> u8-encoded scale/base (EncodeScale/EncodeBase; stored here as the
               decoded fp32 values in an f32 plane so dequant math is uniform)
    """

    name: str
    block: int
    planes: Tuple[PlaneSpec, ...]
    scale_div: int  # scale = (max - min) / scale_div
    max_code: int
    rounding: str = "half_up"
    base_kind: str = "min"
    meta: str = "f16"
    pair_base11: bool = False  # Q3H: codes are base-11 packed value pairs
    signed: bool = False  # int8 codes (Q8_B32T2)
    adjust_base: bool = False  # apply AdjustBase() before scale calc (Q4_B16)

    @property
    def code_bits(self) -> int:
        return sum(p.bits for p in self.planes)

    @property
    def effective_bits(self) -> float:
        """Bits per weight including block metadata (scale/base planes)."""
        meta_bytes = 2.0 if self.meta == "u8" else (
            2.0 if self.base_kind == "zero" else 4.0)
        per_pair = 2 if self.pair_base11 else 1
        data_bits = self.code_bits / per_pair
        return data_bits + meta_bytes * 8.0 / self.block

    @property
    def values_per_byte(self) -> dict:
        return {p.name: 8 // p.bits for p in self.planes}


def _f(name, block, planes, scale_div, max_code, **kw) -> QuantFormat:
    return QuantFormat(name=name, block=block,
                       planes=tuple(PlaneSpec(*p) for p in planes),
                       scale_div=scale_div, max_code=max_code, **kw)


# Registry keyed by element-type name (mirrors ElementType,
# reference: src/tensor/tensor_common.h:15-42).
FORMATS = {
    # 8-bit, block 32, fp16 base+scale (quant_types.h:11)
    "Q8_B32T1": _f("Q8_B32T1", 32, [("data", 8)], 255, 255),
    # 8-bit symmetric, block 32 (quant_types.h:22); scale=absmax/127, int8 codes
    "Q8_B32T2": _f("Q8_B32T2", 32, [("data", 8)], 127, 127,
                   rounding="round", base_kind="zero", signed=True),
    # 6-bit, block 64 (quant_types.h:34); scale=(max-min)/62
    "Q6_B64T1": _f("Q6_B64T1", 64, [("data", 4), ("data_h", 2)], 62, 63),
    # 5-bit, block 64 (quant_types.h:46); scale=(max-min)/30
    "Q5_B64T1": _f("Q5_B64T1", 64, [("data", 4), ("data_h", 1)], 30, 31),
    # 5-bit, block 32, ggml-style split-nibble layout (quant_types.h:55)
    "Q5_B32T1": _f("Q5_B32T1", 32,
                   [("data", 4, "split_half"), ("data_h", 1)], 31, 31),
    # 4-bit, block 64 (quant_types.h:67); scale=(max-min)/14
    "Q4_B64T1": _f("Q4_B64T1", 64, [("data", 4)], 14, 15),
    # 4-bit, block 32, A-variant rounding (quant_types.h:79)
    "Q4_B32T1A": _f("Q4_B32T1A", 32, [("data", 4)], 15, 15),
    # 4-bit, block 32, B-variant (mid base, truncating)
    "Q4_B32T1B": _f("Q4_B32T1B", 32, [("data", 4)], 16, 15,
                    rounding="trunc_eps", base_kind="mid"),
    # 4-bit, block 32, u8 metadata (quant_types.h:90)
    "Q4_B32T2": _f("Q4_B32T2", 32, [("data", 4)], 15, 15, meta="u8",
                   adjust_base=True),
    # 4-bit, block 16, u8 metadata (quant_types.h:101)
    "Q4_B16": _f("Q4_B16", 16, [("data", 4)], 15, 15, meta="u8",
                 adjust_base=True),
    # 3.5-bit, block 64: 11 levels, pairs packed base-11 into 7 bits
    # (quant_types.h:112, quantization.h:809-926)
    "Q3H_B64T1": _f("Q3H_B64T1", 64,
                    [("data", 4), ("data_m", 2), ("data_h", 1)], 10, 10,
                    pair_base11=True),
    # 3-bit, block 32 (quant_types.h:125)
    "Q3_B32T1A": _f("Q3_B32T1A", 32, [("data", 2), ("data_h", 1)], 7, 7),
    "Q3_B32T1B": _f("Q3_B32T1B", 32, [("data", 2), ("data_h", 1)], 8, 7,
                    rounding="trunc_eps", base_kind="mid"),
    # 2-bit, block 32 (quant_types.h:160)
    "Q2_B32T1A": _f("Q2_B32T1A", 32, [("data", 2)], 3, 3),
    "Q2_B32T1B": _f("Q2_B32T1B", 32, [("data", 2)], 4, 3,
                    rounding="trunc_eps", base_kind="mid"),
}

# Dense (non-quantized) element types, for completeness of the ElementType
# surface (tensor_common.h:15-42).
DENSE_TYPES = ("F32", "F16", "BF16", "I32", "I16")

# Whole-tensor 8-bit schemes (quantization.h:21-29); see codec_np.Quantize_Q8_Linear.
GLOBAL_TYPES = ("Q8_GL", "Q8_LOG")

ALIASES = {
    "Q4_B32T1": "Q4_B32T1A",
    "Q3_B32T1": "Q3_B32T1A",
    "Q2_B32T1": "Q2_B32T1A",
    "Q3H": "Q3H_B64T1",
    "Q8": "Q8_B32T2",
    "Q6": "Q6_B64T1",
    "Q5": "Q5_B64T1",
    "Q4": "Q4_B64T1",
    "Q3": "Q3_B32T1A",
    "Q2": "Q2_B32T1A",
}


def get_format(name: str) -> QuantFormat:
    key = name.upper()
    key = ALIASES.get(key, key)
    if key not in FORMATS:
        raise KeyError(f"unknown quant format: {name}")
    return FORMATS[key]


def is_quantized(name: str) -> bool:
    key = name.upper()
    return ALIASES.get(key, key) in FORMATS


def normalize_element_type(name: str) -> str:
    """Canonical element-type name (dense, global, or block format)."""
    key = name.upper()
    if key in DENSE_TYPES or key in GLOBAL_TYPES:
        return key
    return get_format(key).name
