"""Dequantize-matmul (kernel B1): y = x @ dequant(W) for block-quantized W.

Port of inferflow_tpu/kernels/dequant_matmul.py (`quantized_matmul`, whose
fast Pallas kernel is `_make_fast_kernel`).  On a CUDA tensor the wrapper
launches the hand-written kernel of ``csrc/dequant_matmul.cu`` (Q4_B64T1
wire planes) or raises; on a CPU tensor it runs the plain version, which is
also what ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.codec_torch import QuantizedTensor, dequantize
from ..quant.formats import get_format
from . import _build

KERNEL = "dequant_matmul"


def quantized_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version: dequantize (bf16-rounded weights) and a float32
    matmul, cast back to x's dtype.  x: (..., K)."""
    wd = dequantize(qt, torch.bfloat16).float()
    return torch.matmul(x.float(), wd).to(x.dtype)


def _lib():
    lib = _build.load(KERNEL)
    if not getattr(lib, "_ift_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ift_q4_matmul.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                      vp]
        lib.ift_q4_matmul.restype = ctypes.c_int
        lib.ift_q4_matmul_plan.argtypes = [i, i, i, i,
                                           ctypes.POINTER(i),
                                           ctypes.POINTER(i)]
        lib.ift_q4_matmul_plan.restype = ctypes.c_int
        lib._ift_typed = True
    return lib


def matmul_plan(lib, m: int, k: int, n: int, device) -> tuple:
    """(quant blocks per K split, number of splits) that the kernel's C
    side picks for this product on this card's SM count; (0, 1) for the
    tiled (prefill) path."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per, ksplit = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.ift_q4_matmul_plan(m, k, n, sms, ctypes.byref(per),
                                             ctypes.byref(ksplit)),
                 "dequant_matmul plan")
    return per.value, ksplit.value


def _check_kernel_format(qt: QuantizedTensor) -> None:
    fmt = get_format(qt.format)
    if (fmt.name != "Q4_B64T1" or set(qt.planes) != {"data"}
            or qt.scale.dtype != torch.float16 or qt.base is None):
        raise NotImplementedError(
            f"the CUDA dequant-matmul kernel serves Q4_B64T1 wire planes; "
            f"got {fmt.name} with planes {sorted(qt.planes)}")


def quantized_matmul_cuda(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Launch the kernel on (M, K_s) bf16 activations; returns (M, N) bf16."""
    _check_kernel_format(qt)
    _build.require_hopper(x2)
    m, k = x2.shape
    n = int(qt.shape[-1])
    if n % 16:
        raise ValueError(f"N={n} must be a multiple of 16")
    data = qt.planes["data"]
    _build.check_operand(x2, "x", torch.bfloat16, (m, k))
    _build.check_operand(data, "data", torch.uint8, (k // 2, n))
    _build.check_operand(qt.scale, "scale", torch.float16, (k // 64, n))
    _build.check_operand(qt.base, "base", torch.float16, (k // 64, n))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    lib = _lib()
    per, ksplit = matmul_plan(lib, m, k, n, x2.device)
    work = (torch.empty((ksplit, m, n), dtype=torch.float32, device=x2.device)
            if ksplit > 1 else out)
    rc = lib.ift_q4_matmul(_build.ptr(x2), _build.ptr(data),
                           _build.ptr(qt.scale), _build.ptr(qt.base),
                           _build.ptr(out), _build.ptr(work), m, k, n, per,
                           ksplit, _build.stream_of(x2))
    _build.check(lib, rc, "dequant_matmul")
    _build.launch_counts[KERNEL] += 1
    return out


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """y = x @ dequant(qt); x: (..., K) with K the logical K of qt.

    CUDA tensors run the kernel (or raise); CPU tensors the plain version.
    Storage K beyond the logical K (zero-scale pad blocks) takes
    zero-padded activations, as the JAX wrapper does."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    k, n = int(qt.shape[-2]), int(qt.shape[-1])
    k_s = qt.storage_k
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if k_s != k:
        x2 = torch.nn.functional.pad(x2, (0, k_s - k))
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = quantized_matmul_cuda(x2, qt)
    return out.reshape(lead + (n,)).to(x.dtype)

