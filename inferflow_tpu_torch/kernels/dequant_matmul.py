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
(``q3h_matmul``) and in its wire mode for Q3H_B64T1's three wire planes
(``q3h_wire_matmul``; ``from_np(..., fast_layout=False)`` and
``pair8_to_wire`` give them, as the JAX ``quantized_matmul`` routes them
to the same kernel).  B6's non-pair branch, the format-generic function,
is reached only through ``generic_matmul`` (launch count
``generic_matmul``), which the kernel bench calls: no route of the JAX
package reaches it either (``_fast_eligible`` sends every non-pair format
to B1).  Its weights are B1's bit for bit, so it launches the B1 entry
compiled for the format (``_launch_generic``).  On a CUDA tensor the
entries launch the hand-written kernel of ``csrc/dequant_matmul.cu`` or
``csrc/subbyte_matmul.cu`` (both built on ``csrc/dequant_matmul.cuh``) or
raise; on a CPU tensor they run the plain version, which is also what
``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.codec_torch import (I4_PLANE, PAIR8_PLANE, QuantizedTensor,
                                 _codes, dequantize, i4_nibbles)
from ..quant.formats import get_format
from . import _build

KERNEL = "dequant_matmul"
Q8_KERNEL = "q8_matmul"
I4_KERNEL = "i4_matmul"  # B5 on Q4_B64T1
I4_B32_KERNEL = "i4_matmul_b32"  # B5 on Q4_B32T1A / B (32 rows, f16)
I4_B32F_KERNEL = "i4_matmul_b32f"  # B5 on Q4_B32T2 (32 rows, f32)
I4_B16F_KERNEL = "i4_matmul_b16f"  # B5 on Q4_B16 (16 rows, f32)
Q3H_KERNEL = "q3h_matmul"
Q3H_WIRE_KERNEL = "q3h_wire_matmul"  # B6's wire mode
GENERIC_KERNEL = "generic_matmul"  # B6's non-pair branch
SUBBYTE_KERNEL = "subbyte_matmul"


def quantized_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version: dequantize (bf16-rounded weights) and a float32
    matmul, cast back to x's dtype.  x: (..., K)."""
    wd = dequantize(qt, torch.bfloat16).float()
    return torch.matmul(x.float(), wd).to(x.dtype)


# (plane, format) -> (launch count, source under csrc/, C entry).  The
# ``data`` plane stands for a format's wire planes (``data`` and, for the
# two-plane formats, ``data_h``; Q3H's ``data``, ``data_m`` and ``data_h``
# over its K/2 pair codes, an entry with three plane arguments); the i4 and
# pair8 planes hold two K rows per byte.
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
    ("data", "Q3H_B64T1"): (Q3H_WIRE_KERNEL, "dequant_matmul",
                            "ift_q3h_wire_matmul"),
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
        vp, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        for (plane, fmt), (_, src, entry) in _KERNELS.items():
            if src == source:
                fn = getattr(lib, entry)
                planes = max(2, len(_plane_names(plane, get_format(fmt))))
                # x, planes, scale, base, out, workspace, counters
                fn.argtypes = [vp] * (6 + planes) + [i] * 5 + [vp]
                fn.restype = ctypes.c_int
                plan = getattr(lib, entry + "_plan")
                plan.argtypes = [i, i, i, i, pi, pi]
                plan.restype = ctypes.c_int
        lib._ift_typed = True
    return lib


def matmul_plan(lib, m: int, k: int, n: int, device, entry: str) -> tuple:
    """(quant blocks per K split, number of splits) that C entry `entry`'s
    plan picks for this product on this card's SM count: the tensor-core
    GEMV's, or at one row on a single plane of at most 4 bits or a split
    plane the CUDA-core GEMV's; (0, 1) for the tiled (prefill) path."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per, ksplit = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, entry + "_plan")(m, k, n, sms, ctypes.byref(per),
                                       ctypes.byref(ksplit))
    _build.check(lib, rc, "dequant_matmul plan")
    return per.value, ksplit.value


# The tensor-core GEMV's column-tile counters by (device, stream): zero
# between launches (the last CTA of a tile leaves its counter zero), so no
# launch pays for zeroing them
_COUNTERS: dict = {}


def _counters(x: torch.Tensor, tiles: int) -> torch.Tensor:
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 512), dtype=torch.int32,
                          device=x.device)
        _COUNTERS[key] = buf
    return buf


def _plane_names(plane: str, fmt) -> list:
    """The planes the kernel of `plane` reads, in its argument order."""
    return [p.name for p in fmt.planes] if plane == "data" else [plane]


def _plane_rows(qt: QuantizedTensor, plane: str) -> dict:
    """{plane name: stored byte rows} the kernel of `plane` reads: a wire
    plane of b bits holds b/8 byte rows per code (a Q3H code per two K
    rows), the i4 and pair8 planes one byte row per two K rows."""
    fmt = get_format(qt.format)
    if plane != "data":
        return {plane: qt.storage_k // 2}
    codes = qt.storage_k // 2 if fmt.pair_base11 else qt.storage_k
    return {p.name: codes * p.bits // 8 for p in fmt.planes}


def _plane(qt: QuantizedTensor) -> str:
    """The _KERNELS plane key of qt: its i4 or pair8 plane, else "data"
    (the format's wire planes)."""
    return next((p for p in (I4_PLANE, PAIR8_PLANE) if p in qt.planes),
                "data")


def kernel_name(qt: QuantizedTensor) -> str:
    """The launch count of the kernel quantized_matmul runs for qt on the
    card (KeyError for a plane it has no kernel for)."""
    return _KERNELS[_plane(qt), get_format(qt.format).name][0]


def _launch(x: torch.Tensor, qt: QuantizedTensor,
            count: str = None) -> torch.Tensor:
    """y = x @ W through kernel B1, B5 or B6 on the card; x: (..., K) with K
    the logical K of qt.  The kernels take (M, K_s) contiguous bf16 rows,
    16-byte aligned: a stored K beyond the logical K (zero-scale,
    zero-base pad blocks) takes zero-padded activations, as the JAX
    wrapper does.  The launch counts under `count`, else the kernel's
    name."""
    fmt = get_format(qt.format)
    plane = _plane(qt)
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
    n = int(qt.shape[-1])
    k_s = qt.storage_k
    if n % 16:
        raise ValueError(f"N={n} must be a multiple of 16")
    x2 = _pad_activations(x, qt)
    m = x2.shape[0]
    blk = fmt.block
    for name, r in rows.items():
        _build.check_operand(qt.planes[name], name, torch.uint8, (r, n))
    _build.check_operand(qt.scale, "scale", meta, (k_s // blk, n))
    if has_base:
        _build.check_operand(qt.base, "base", meta, (k_s // blk, n))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    lib = _lib(source)
    per, ksplit = matmul_plan(lib, m, k_s, n, x2.device, entry)
    work = (torch.empty((ksplit, m, n), dtype=torch.float32, device=x2.device)
            if ksplit > 1 else out)
    planes = [_build.ptr(qt.planes[name])
              for name in _plane_names(plane, fmt)]
    planes += [ctypes.c_void_p(0)] * (2 - len(planes))  # data_h unused
    base = _build.ptr(qt.base) if has_base else ctypes.c_void_p(0)
    counters = _build.ptr(_counters(x2, -(-n // 128)))
    rc = getattr(lib, entry)(_build.ptr(x2), *planes,
                             _build.ptr(qt.scale), base,
                             _build.ptr(out), _build.ptr(work), counters,
                             m, k_s, n, per, ksplit, _build.stream_of(x2))
    kernel = count or kernel
    _build.check(lib, rc, kernel)
    _build.launch_counts[kernel] += 1
    return out.reshape(x.shape[:-1] + (n,)).to(x.dtype)


def _pad_activations(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x (..., K) as the (M, K_s) contiguous, 16-byte aligned bf16 rows
    the kernels take: zero columns past the logical K of a K-padded
    tensor (its pad blocks have zero scale and base)."""
    k, k_s = int(qt.shape[-2]), qt.storage_k
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if k_s != k:
        x2 = torch.nn.functional.pad(x2, (0, k_s - k))
    x2 = x2.contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


def generic_entry(fmt_name: str) -> tuple:
    """(source under csrc/, C entry) that B6's non-pair branch launches for
    a block format's wire planes: the format's own B1 entry, whose weights
    (bf16(code*scale + base), or code*scale without a base, as two rounded
    float32 operations) are the branch's bit for bit.  NotImplementedError
    names a format with no compiled entry."""
    fmt = get_format(fmt_name)
    if fmt.pair_base11 or ("data", fmt.name) not in _KERNELS:
        raise NotImplementedError(
            f"B6's non-pair branch has no compiled entry for {fmt.name}")
    return _KERNELS["data", fmt.name][1:]


def _launch_generic(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ W through B6's non-pair branch on the card: the B1 entry of
    qt's format (generic_entry) on its wire planes, counted as
    ``generic_matmul``."""
    fmt = get_format(qt.format)
    generic_entry(fmt.name)
    names = [p.name for p in fmt.planes]
    if set(qt.planes) != set(names):
        raise NotImplementedError(
            f"B6's non-pair branch reads {fmt.name}'s wire planes "
            f"{names}; got {sorted(qt.planes)}")
    return _launch(x, qt, count=GENERIC_KERNEL)


def generic_weight(qt: QuantizedTensor) -> torch.Tensor:
    """The (K, N) bf16 weights of B6's non-pair branch (the TPU kernel's
    non-pair function): the planes' combined codes, reinterpreted as int8
    (codes - ((codes >> 7) << 8)) when the format is signed, q*scale
    (+ base when the format has one) in float32, rounded once to bf16."""
    fmt = get_format(qt.format)
    k_s, n = qt.storage_k, int(qt.shape[-1])
    codes = _codes(qt.planes, fmt)
    if fmt.signed:
        codes = codes - ((codes >> 7) << 8)
    w = codes.float().view(k_s // fmt.block, fmt.block, n) \
        * qt.scale.float()[:, None, :]
    if fmt.base_kind != "zero":
        w = w + qt.base.float()[:, None, :]
    return w.reshape(k_s, n).to(torch.bfloat16)[:int(qt.shape[-2])]


def generic_matmul_plain(x: torch.Tensor, qt: QuantizedTensor
                         ) -> torch.Tensor:
    """The plain version of B6's non-pair branch: generic_weight's bf16
    weights and a float32 matmul, cast back to x's dtype."""
    return torch.matmul(x.float(), generic_weight(qt).float()).to(x.dtype)


def generic_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt) through B6's non-pair branch, for any block
    format but Q3H in its wire planes; x: (..., K).  No serving route takes
    it (quantized_matmul picks B1's per-format kernels): the kernel bench
    calls it.  CUDA tensors launch the kernel or raise; CPU tensors run
    generic_matmul_plain."""
    fmt = get_format(qt.format)
    if fmt.pair_base11:
        raise ValueError("Q3H is a pair format: quantized_matmul takes it "
                         "(B6's pair8 or wire mode)")
    if x.device.type == "cpu":
        return generic_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"generic_matmul: unsupported device {x.device}")
    return _launch_generic(x, qt)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt); x: (..., K) with K the logical K of qt; every
    quantized product of ops/linear.py.  CUDA tensors run the kernel of
    qt's plane and format (_KERNELS: B5 for ``data_i4p``, B6 for
    ``pair8`` and, in its wire mode, for Q3H's wire planes, B1 for the
    wire planes of every other block format; M <= 8 the GEMV on the tensor
    cores with its K splits merged in the same launch, or at one row on a
    single plane of at most 4 bits the CUDA-core loop; more rows the tiled
    tensor-core kernel) or raise; CPU tensors its plain version
    (i4_matmul_plain for B5, quantized_matmul_plain for B1 and B6, whose
    weights are the codec's bit for bit)."""
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
