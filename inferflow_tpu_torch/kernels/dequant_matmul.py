"""Dequantize-matmul: y = x @ dequant(W) for block-quantized W.

Port of inferflow_tpu/kernels/dequant_matmul.py.  One entry point,
``quantized_matmul``, picks the kernel from the weight's plane and format:
kernel B1 (the fast Pallas kernel `_make_fast_kernel`) for every block
format in its wire planes -- Q4_B64T1 (launch count ``dequant_matmul``),
the Q8 formats Q8_B32T2 (the ``Q8`` alias and the q8c container) and
Q8_B32T1 (``q8_matmul``), and the sub-byte formats Q6_B64T1, Q5_B64T1,
Q5_B32T1, Q4_B32T1A/B, Q4_B32T2, Q4_B16, Q3_B32T1A/B and Q2_B32T1A/B
(``subbyte_matmul``) --, kernel B5 (`_make_i4_kernel`) for the i4 device
layout's ``data_i4p`` plane of the four 4-bit single-plane formats
(Q4_B64T1: ``i4_matmul``; Q4_B32T1A/B: ``i4_matmul_b32``; Q4_B32T2:
``i4_matmul_b32f``; Q4_B16: ``i4_matmul_b16f``), and kernel B6
(`_make_kernel`) in its pair8 mode for Q3H_B64T1's ``pair8`` plane
(``q3h_matmul``).  On a CUDA tensor it launches the hand-written kernel of
``csrc/dequant_matmul.cu`` or ``csrc/subbyte_matmul.cu`` (both built on
``csrc/dequant_matmul.cuh``) or raises; on a CPU tensor it runs the plain
version, which is also what ``chip_smoke.py`` holds the kernel against on
the card.  B6's Q3H wire-plane mode and its non-pair generic branch are
not ported (no serving route reaches them: ``from_np`` and ``quantize``
give Q3H as pair8).
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.codec_torch import (I4_PLANE, PAIR8_PLANE, QuantizedTensor,
                                 dequantize, i4_nibbles)
from ..quant.formats import get_format
from . import _build

KERNEL = "dequant_matmul"
Q8_KERNEL = "q8_matmul"
I4_KERNEL = "i4_matmul"  # B5 on Q4_B64T1
I4_B32_KERNEL = "i4_matmul_b32"  # B5 on Q4_B32T1A / B (32 rows, f16)
I4_B32F_KERNEL = "i4_matmul_b32f"  # B5 on Q4_B32T2 (32 rows, f32)
I4_B16F_KERNEL = "i4_matmul_b16f"  # B5 on Q4_B16 (16 rows, f32)
Q3H_KERNEL = "q3h_matmul"
SUBBYTE_KERNEL = "subbyte_matmul"


def quantized_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version: dequantize (bf16-rounded weights) and a float32
    matmul, cast back to x's dtype.  x: (..., K)."""
    wd = dequantize(qt, torch.bfloat16).float()
    return torch.matmul(x.float(), wd).to(x.dtype)


# (plane, format) -> (launch count, source under csrc/, C entry).  The
# ``data`` plane stands for a format's wire planes (``data`` and, for the
# two-plane formats, ``data_h``); the i4 and pair8 planes hold two K rows
# per byte.
_KERNELS = {
    ("data", "Q4_B64T1"): (KERNEL, "dequant_matmul", "ift_q4_matmul"),
    ("data", "Q8_B32T2"): (Q8_KERNEL, "dequant_matmul", "ift_q8_matmul"),
    ("data", "Q8_B32T1"): (Q8_KERNEL, "dequant_matmul", "ift_q8u_matmul"),
    (I4_PLANE, "Q4_B64T1"): (I4_KERNEL, "dequant_matmul", "ift_i4_matmul"),
    (I4_PLANE, "Q4_B32T1A"): (I4_B32_KERNEL, "dequant_matmul",
                              "ift_i4b32_matmul"),
    (I4_PLANE, "Q4_B32T1B"): (I4_B32_KERNEL, "dequant_matmul",
                              "ift_i4b32_matmul"),
    (I4_PLANE, "Q4_B32T2"): (I4_B32F_KERNEL, "dequant_matmul",
                             "ift_i4b32f_matmul"),
    (I4_PLANE, "Q4_B16"): (I4_B16F_KERNEL, "dequant_matmul",
                           "ift_i4b16f_matmul"),
    (PAIR8_PLANE, "Q3H_B64T1"): (Q3H_KERNEL, "dequant_matmul",
                                 "ift_q3h_matmul"),
    **{("data", fmt): (SUBBYTE_KERNEL, "subbyte_matmul", entry)
       for fmt, entry in (("Q6_B64T1", "ift_q6_matmul"),
                          ("Q5_B64T1", "ift_q5_matmul"),
                          ("Q5_B32T1", "ift_q5s_matmul"),
                          ("Q4_B32T1A", "ift_q4b32_matmul"),
                          ("Q4_B32T1B", "ift_q4b32_matmul"),
                          ("Q4_B32T2", "ift_q4b32f_matmul"),
                          ("Q4_B16", "ift_q4b16f_matmul"),
                          ("Q3_B32T1A", "ift_q3_matmul"),
                          ("Q3_B32T1B", "ift_q3_matmul"),
                          ("Q2_B32T1A", "ift_q2_matmul"),
                          ("Q2_B32T1B", "ift_q2_matmul"))},
}


def _lib(source: str = "dequant_matmul"):
    """The loaded library of csrc/<source>.cu, its entries typed."""
    lib = _build.load(source)
    if not getattr(lib, "_ift_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        for _, src, entry in _KERNELS.values():
            if src == source:
                fn = getattr(lib, entry)
                fn.argtypes = [vp] * 7 + [i] * 5 + [vp]
                fn.restype = ctypes.c_int
        lib.ift_matmul_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
        lib.ift_matmul_plan.restype = ctypes.c_int
        lib._ift_typed = True
    return lib


def matmul_plan(lib, m: int, k: int, n: int, device, block: int = 64
                ) -> tuple:
    """(quant blocks per K split, number of splits) that the kernel's C
    side picks for this product of `block`-row quant blocks (64, 32 or 16)
    on this card's SM count; (0, 1) for the tiled (prefill) path."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per, ksplit = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.ift_matmul_plan(m, k, n, block, sms,
                                          ctypes.byref(per),
                                          ctypes.byref(ksplit)),
                 "dequant_matmul plan")
    return per.value, ksplit.value


def _plane_rows(qt: QuantizedTensor, plane: str) -> dict:
    """{plane name: stored byte rows} the kernel of `plane` reads."""
    fmt = get_format(qt.format)
    if plane != "data":
        return {plane: qt.storage_k // 2}
    return {p.name: qt.storage_k * p.bits // 8 for p in fmt.planes}


def _launch(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ W through kernel B1, B5 or B6 on the card; x: (..., K) with K
    the logical K of qt.  The kernels take (M, K_s) contiguous bf16 rows,
    16-byte aligned: a stored K beyond the logical K (zero-scale,
    zero-base pad blocks) takes zero-padded activations, as the JAX
    wrapper does."""
    fmt = get_format(qt.format)
    plane = next((p for p in (I4_PLANE, PAIR8_PLANE) if p in qt.planes),
                 "data")
    rows = _plane_rows(qt, plane)
    if (plane, fmt.name) not in _KERNELS or set(qt.planes) != set(rows):
        raise NotImplementedError(
            f"no CUDA kernel serves {fmt.name} with planes "
            f"{sorted(qt.planes)}; ported: "
            + ", ".join(f"{f} ({p})" for p, f in _KERNELS))
    kernel, source, entry = _KERNELS[plane, fmt.name]
    has_base = fmt.base_kind != "zero"
    meta = torch.float32 if fmt.meta == "u8" else torch.float16
    _build.require_hopper(x)
    k, n = int(qt.shape[-2]), int(qt.shape[-1])
    k_s = qt.storage_k
    if n % 16:
        raise ValueError(f"N={n} must be a multiple of 16")
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if k_s != k:
        x2 = torch.nn.functional.pad(x2, (0, k_s - k))
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    m = x2.shape[0]
    blk = fmt.block
    for name, r in rows.items():
        _build.check_operand(qt.planes[name], name, torch.uint8, (r, n))
    _build.check_operand(qt.scale, "scale", meta, (k_s // blk, n))
    if has_base:
        _build.check_operand(qt.base, "base", meta, (k_s // blk, n))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    lib = _lib(source)
    per, ksplit = matmul_plan(lib, m, k_s, n, x2.device, blk)
    work = (torch.empty((ksplit, m, n), dtype=torch.float32, device=x2.device)
            if ksplit > 1 else out)
    planes = [_build.ptr(qt.planes[name]) for name in rows]
    null = ctypes.c_void_p(0)
    data_h = planes[1] if len(planes) > 1 else null
    base = _build.ptr(qt.base) if has_base else null
    rc = getattr(lib, entry)(_build.ptr(x2), planes[0], data_h,
                             _build.ptr(qt.scale), base,
                             _build.ptr(out), _build.ptr(work), m, k_s, n,
                             per, ksplit, _build.stream_of(x2))
    _build.check(lib, rc, kernel)
    _build.launch_counts[kernel] += 1
    return out.reshape(x.shape[:-1] + (n,)).to(x.dtype)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt); x: (..., K) with K the logical K of qt; every
    quantized product of ops/linear.py.  CUDA tensors run the kernel of
    qt's plane and format (_KERNELS: B5 for ``data_i4p``, B6 for
    ``pair8``, B1 for the wire planes of every other block format; M <= 8
    the split-K GEMV, more rows the tiled tensor-core kernel) or raise;
    CPU tensors its plain version (i4_matmul_plain for B5,
    quantized_matmul_plain for B1 and B6, whose weights are the codec's
    bit for bit)."""
    if x.device.type == "cpu":
        if I4_PLANE in qt.planes:
            return i4_matmul_plain(x, qt)
        return quantized_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    return _launch(x, qt)


# ------------------------------------------------------------ kernel B5
def i4_weight(qt: QuantizedTensor) -> torch.Tensor:
    """The (K, N) bf16 weights B5 multiplies by: bf16(n*sc + fold), with n
    the signed nibble and fold = 8*sc + base in float32 (the TPU kernel's
    arithmetic; codec_torch.dequantize computes (n + 8)*sc + base, whose
    one rounding can differ from these two by an ulp), per block of the
    format (64, 32 or 16 rows).  Scale and base are taken as the codec
    stores them, f16 or f32: for Q4_B32T2 and Q4_B16 the TPU kernel reads
    their f32 values as f16 bits (ROADMAP C7), the port does not."""
    blk = get_format(qt.format).block
    k_s, n = qt.storage_k, int(qt.shape[-1])
    sc = qt.scale.float()
    fold = sc * 8.0
    if qt.base is not None:
        fold = fold + qt.base.float()
    w = i4_nibbles(qt.planes[I4_PLANE]).float().view(k_s // blk, blk, n)
    w = (w * sc[:, None, :] + fold[:, None, :]).to(torch.bfloat16)
    return w.reshape(k_s, n)[:int(qt.shape[-2])]


def i4_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of B5: i4_weight's bf16 weights and a float32
    matmul, cast back to x's dtype.  x: (..., K)."""
    return torch.matmul(x.float(), i4_weight(qt).float()).to(x.dtype)
