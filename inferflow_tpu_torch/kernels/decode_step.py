"""Whole-model fused decode step (kernel B4), the i8mm int8 product and the
i4 layout's two products.

Port of inferflow_tpu/kernels/decode_step.py (`fused_step_supported`,
`fused_step_preferred`, `fused_decode_step`) in every weight mode of the
TPU kernel: (a) i8mm (Int8MXUTensor weights: int8 codes with one f32
scale per column), (b) i4x8 and (b') bf16-unpack, the i4 layout's two
modes (its ``data_i4p`` nibbles with their block scales and bases, for
every 4-bit single-plane format: Q4_B64T1, Q4_B32T1A/B with f16 metadata,
Q4_B32T2 and Q4_B16 with f32; the f32 metadata is read as stored, where
the TPU kernel reads it as f16 bits, ROADMAP C7): i4x8 quantizes the
activations to int8 per row and takes one int32 dot per quant block, the
TPU kernel's default; (b') keeps the exact bf16 activations and unpacks
every weight to bf16(bf16(n) * bf16(scale)), the TPU kernel's mode under
INFERFLOW_I4_DOT set to anything but ``i8``, read when a step is routed
(as the TPU package reads it) so that one process can run both; (c)
byte (the Q8 block formats Q8_B32T2 and Q8_B32T1, one code per byte:
bf16 activations, each weight bf16(q * bf16(scale)), Q8_B32T1's base
through the blocks' activation sums); the wire mode (the sub-byte
single-plane wire planes Q4_B64T1, Q4_B32T1A/B and Q2_B32T1A/B, pk = 2 or
4 codes per byte, with byte (c)'s arithmetic); (h) Q3H in the pair8
layout (one byte per base-11 value pair, the same arithmetic); the GEMVs
of (b'), the wire mode and (h) run on one tensor-core walk, (c)'s on the
CUDA cores; each product in its own mode; (d) per-matmul float32 output
biases, added to a product's output before the residual add, the GLU or
the qkv split;
MoE layers in the TPU kernel's routed-expert mode (g) (moe_slot: an f32
gate dot, softmax, per-slot top-k, then each chosen expert's w1n3 and w2,
the residual rounded to bf16 after each expert in top-k order), with
experts in any of these modes;
and a Q8 KV cache in the logical layout, dense (runtime/kv_cache.py) or
paged (runtime/paged_kv.py, the TPU kernel's mode (f): the walk and the
step's K/V rows go through the page table), with both attention modes of
the TPU kernel: per-slot (B = 1, float32 throughout) and batched (B > 1:
q, and p * vscale, rounded to bf16 before the cache dots).

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/decode_step.cu`` or raise: the step is one C call that walks a
per-layer pointer table (a weight mode and a bias per product) and issues
five launches per layer (three kinds of GEMV and the step attention), and
writes each layer's new K/V row straight into the cache; a MoE layer's
FFN takes a routing launch, the experts' GEMVs (each chosen expert read
once for all the slots that chose it, one launch per row count) and a
combine.  The walk's GEMVs are launched as programmatic dependents: each
starts to stream its first weight slots while the launch before it on
the stream (a GEMV of the walk or the step attention, which let their
dependents start early) is still running, and reads its activations only
once that launch has finished.  So no kernel may write, on the stream, a
weight that a walk GEMV after it reads: the port writes weights only when
it loads, quantizes or repacks them, before any step, and a kernel that
does not let its dependents start early (any PyTorch kernel) has finished
before the GEMV starts (``tests/test_torch_cuda_b4_modes.py`` rewrites a
weight in place between two GEMVs).  On CPU tensors
they run the plain versions below, which follow the TPU kernel's
arithmetic (outputs, then ``append_rows_all_layers`` or
``append_rows_all_layers_paged``) and which ``chip_smoke.py`` also holds
the kernels against on the card.

Routing follows the TPU package: ``fused_step_preferred`` sends the wire
mode and mode (h), which the TPU package supports but does not prefer, to
the per-layer loop (kernels B1 or B6, and B2).  INFERFLOW_MEGA is read at
each routing decision (``mega_mode``), as the TPU package reads it: ``0``
sends every decode step to the per-layer loop, ``2`` takes the fused step
wherever it is supported (the wire mode and mode (h) included).  MoE
layers of more than 64 experts are not taken (NotImplementedError).
There is no fallback switch: if the kernel fails to build or launch, the
step raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from ..quant.codec_torch import (I4_PLANE, PAIR8_PLANE, Int8MXUTensor,
                                 QuantizedTensor, _unpack_plane, i4_nibbles,
                                 int8_rowwise_activations, pair8_values,
                                 true_div)
from ..quant.formats import get_format
from ..runtime.kv_cache import KVCache, append_rows_all_layers
from ..runtime.paged_kv import (PagedKVCache, append_rows_all_layers_paged,
                                kv_pack_for)
from . import _build

KERNEL = "fused_decode_step"  # a step whose products are all i8mm
I4_KERNEL = "fused_decode_step_i4"  # a step with an i4x8 product (Q4_B64T1)
BYTE_KERNEL = "fused_decode_step_byte"  # a step with a byte-mode product
BYTE_GEMV_KERNEL = "byte_gemv"  # the byte GEMV alone (Q8_B32T2, Q8_B32T1)
MOE_KERNEL = "fused_decode_step_moe"  # a step over routed MoE layers (g)
ROUTE_KERNEL = "moe_route"  # mode (g)'s routing launch alone
GEMV_KERNEL = "i8mm_gemv"
I4_GEMV_KERNEL = "i4x8_gemv"  # the i4x8 GEMV alone (Q4_B64T1)
# a step with a (b') product (Q4_B64T1), and the (b') GEMV alone
I4BF16_KERNEL = "fused_decode_step_i4bf16"
I4BF16_GEMV_KERNEL = "i4bf16_gemv"
NEG_INF = -1e30
# float32 sums of int8 x int8 products are exact integers while they stay
# below 2**24: 127 * 127 * 1024 < 2**24
_EXACT_K_CHUNK = 1024
_INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows
_MAX_GEMV_ROWS = 8
_WBUF_BUDGET = 6 * 1024 * 1024  # the TPU kernel's weight tile budget
_ACTS = {"silu": 0, "gelu": 1, "relu": 2}
_MAX_ROWS, _MAX_D = 16, 128  # query heads per kv head, head_dim (csrc)
_TILE_COLS = 128  # GEMV columns per CTA segment (csrc kTileCols)
_MAX_SPLIT = 16  # cache-walk splits per (slot, kv head) (csrc kMaxSplit)
# csrc WeightMode (3: byte with a base; "i4" and "i4bf16" are those of
# Q4_B64T1, the other geometries' follow from _I4_MODES / _I4BF16_MODES)
_MODES = {"i8mm": 0, "i4": 1, "byte": 2, "i4bf16": 7}
# the i4x8 modes by (block rows, metadata type): csrc WeightMode, and the
# launch counts of a step whose i4x8 products take that geometry and of
# the GEMV alone
_I4_MODES = {
    (64, torch.float16): (1, I4_KERNEL, I4_GEMV_KERNEL),  # Q4_B64T1
    (32, torch.float16): (4, I4_KERNEL + "_b32",
                          I4_GEMV_KERNEL + "_b32"),  # Q4_B32T1A / B
    (32, torch.float32): (5, I4_KERNEL + "_b32f",
                          I4_GEMV_KERNEL + "_b32f"),  # Q4_B32T2
    (16, torch.float32): (6, I4_KERNEL + "_b16f",
                          I4_GEMV_KERNEL + "_b16f"),  # Q4_B16
}
# the (b') modes by the same geometries (csrc WeightMode 7-10)
_I4BF16_MODES = {
    (64, torch.float16): (7, I4BF16_KERNEL, I4BF16_GEMV_KERNEL),
    (32, torch.float16): (8, I4BF16_KERNEL + "_b32",
                          I4BF16_GEMV_KERNEL + "_b32"),
    (32, torch.float32): (9, I4BF16_KERNEL + "_b32f",
                          I4BF16_GEMV_KERNEL + "_b32f"),
    (16, torch.float32): (10, I4BF16_KERNEL + "_b16f",
                          I4BF16_GEMV_KERNEL + "_b16f"),
}
_I4_FAMILIES = {"i4": _I4_MODES, "i4bf16": _I4BF16_MODES}
WIRE_KERNEL = "fused_decode_step_wire"  # a step with a wire product
WIRE_GEMV_KERNEL = "wire_gemv"
# the wire modes by (code bits, block rows): csrc WeightMode, the step's
# and the GEMV's launch counts
_WIRE_MODES = {
    (4, 64): (11, WIRE_KERNEL, WIRE_GEMV_KERNEL),  # Q4_B64T1
    (4, 32): (12, WIRE_KERNEL + "_b32",
              WIRE_GEMV_KERNEL + "_b32"),  # Q4_B32T1A / B
    (2, 32): (13, WIRE_KERNEL + "_q2",
              WIRE_GEMV_KERNEL + "_q2"),  # Q2_B32T1A / B
}
PAIR8_KERNEL = "fused_decode_step_pair8"  # a step with a mode (h) product
PAIR8_GEMV_KERNEL = "pair8_gemv"
_PAIR8_MODE = 14  # csrc kModePair8 (Q3H_B64T1)
BIAS_KERNEL = "fused_decode_step_bias"  # also counted for a biased step
_MAX_EXPERTS = 64  # mode (g): experts per MoE layer (csrc kMaxExperts)


# ------------------------------------------------------------ i8mm product
def int8_matmul_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int64, exact: float32 products
    over K chunks of at most 1024 rows (every partial sum an integer below
    2**24, in any summation order), the chunks summed in int64."""
    acc = None
    for k0 in range(0, xq.shape[-1], _EXACT_K_CHUNK):
        part = torch.matmul(xq[..., k0:k0 + _EXACT_K_CHUNK].float(),
                            wq[k0:k0 + _EXACT_K_CHUNK].float())
        part = part.to(torch.int64)
        acc = part if acc is None else acc + part
    return acc


def _i8mm_f32(x: torch.Tensor, w: Int8MXUTensor) -> torch.Tensor:
    """float32 (float(acc) * row scale) * column scale, in that order."""
    xq, xs = int8_rowwise_activations(x)
    return int8_matmul_exact(xq, w.data).float() * xs * w.scale


def i8mm_matmul_plain(x: torch.Tensor, w: Int8MXUTensor) -> torch.Tensor:
    """The plain i8mm product (codec_jax.int8_rowwise_activations, an int32
    dot, row x column scales), cast to x's dtype.  x: (..., K)."""
    return _i8mm_f32(x, w).to(x.dtype)


# ------------------------------------------------------------ i4x8 product
def _i4_fold_term(x: torch.Tensor, w: QuantizedTensor) -> tuple:
    """The part both i4 modes share: x padded to w's stored K (its tail
    zeros), w's block rows, and the block fold term sum_r bf16(sum_{k in
    r} x_k) * bf16(8*sc_r + base_r) in float32 (the TPU tile's xsum dot,
    with the +8 code offset and the base folded in)."""
    blk = get_format(w.format).block
    x = F.pad(x, (0, w.storage_k - x.shape[-1]))
    xsum = x.float().reshape(x.shape[0], -1, blk).sum(-1)
    fold = w.scale.float() * 8.0
    if w.base is not None:
        fold = fold + w.base.float()
    return x, blk, torch.matmul(xsum.to(torch.bfloat16).float(),
                                fold.to(torch.bfloat16).float())


def i4x8_matmul_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """B4 mode (b)'s product, the TPU kernel's i4x8 tile (stream_mm), in
    float32.  x: (M, K) bf16 with K the logical or the stored K of w (the
    stored K's tail takes zeros).  With xq, xs the per-row int8 codes and
    scale of x over the whole row, n the signed nibbles, per quant block
    r of the format (64, 32 or 16 rows; scale and base f16 or f32 as the
    codec stores them, where the TPU kernel reads f32 metadata as f16
    bits: ROADMAP C7):
    acc = sum_r bf16(sum_{k in r} x_k) * bf16(8*sc_r + base_r), then
    acc += f32(sum_{k in r} xq_k * n_k) * (xs * sc_r) block by block, in
    the TPU kernel's order.  Returns (M, N) float32."""
    x, blk, acc = _i4_fold_term(x, w)
    m, nb, n = x.shape[0], w.storage_k // blk, int(w.shape[-1])
    xq, xs = int8_rowwise_activations(x)
    sc = w.scale.float()
    # exact int32 dots as float32: |sum| <= 64 * 127 * 8 < 2**24
    q = i4_nibbles(w.planes[I4_PLANE]).float().reshape(nb, blk, n)
    dots = torch.bmm(xq.float().reshape(m, nb, blk).transpose(0, 1), q)
    for r in range(nb):
        acc = acc + dots[r] * (xs * sc[r])
    return acc


def i4_dot_mode() -> str:
    """The i4 layout's mode of the fused step, as the TPU package's
    ``_mm_cfg`` decides it: "i4" (i4x8) when INFERFLOW_I4_DOT is unset or
    ``i8``, "i4bf16" (b') for any other value.  Read at every routing
    decision, not at import."""
    return ("i4" if os.environ.get("INFERFLOW_I4_DOT", "i8") == "i8"
            else "i4bf16")


def i4_bf16_matmul_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """B4 mode (b')'s product, the TPU kernel's bf16-unpack i4 tile
    (stream_mm, decode_step.py:573-583), in float32.  x: (M, K) bf16 with K
    the logical or the stored K of w (the stored K's tail takes zeros).
    No int8 activations: with n the signed nibbles and, per quant block r
    (64, 32 or 16 rows; scale and base f16 or f32 as the codec stores them,
    ROADMAP C7), acc = sum_r bf16(sum_{k in r} x_k) * bf16(8*sc_r +
    base_r), then acc += sum_k x_k * bf16(bf16(n_k) * bf16(sc_r)) in
    float32.  Returns (M, N) float32."""
    x, blk, acc = _i4_fold_term(x, w)
    k_s, n = w.storage_k, int(w.shape[-1])
    sc = w.scale.to(torch.bfloat16).float()
    q = i4_nibbles(w.planes[I4_PLANE]).float().reshape(k_s // blk, blk, n)
    wq = (q * sc[:, None, :]).to(torch.bfloat16).float()
    return acc + torch.matmul(x.float(), wq.reshape(k_s, n))


# ------------------------------------------------------------ byte product
def _code_matmul_plain(x: torch.Tensor, w: QuantizedTensor,
                       q: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's tiles that take every weight as a whole code (the
    single-plane tile, stream_mm :584-615, and the pair8 tile, :511-536),
    in float32: x (M, K) bf16 with K the logical or the stored K of w (the
    stored K's tail takes zeros), q (K_s, N) the codes as float32.  Per
    quant block r the weights are bf16(bf16(q) * bf16(sc_r)), acc = sum_k
    x_k * w_k in float32, and a base enters once per block as
    bf16(sum_{k in r} x_k) * bf16(base_r), first.  Returns (M, N)
    float32."""
    fmt = get_format(w.format)
    k_s, n = w.storage_k, int(w.shape[-1])
    x = F.pad(x, (0, k_s - x.shape[-1])).float()
    m, nb = x.shape[0], k_s // fmt.block
    sc = w.scale.to(torch.bfloat16).float()
    wq = (q.view(nb, fmt.block, n) * sc[:, None, :]).to(torch.bfloat16)
    acc = torch.matmul(x, wq.float().reshape(k_s, n))
    if w.base is not None:
        xsum = x.reshape(m, nb, fmt.block).sum(-1).to(torch.bfloat16)
        acc = torch.matmul(xsum.float(),
                           w.base.to(torch.bfloat16).float()) + acc
    return acc


def byte_matmul_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """B4 mode (c)'s product, the single-plane tile with one code per byte
    (stream_mm, decode_step.py:583-606), in float32: _code_matmul_plain
    over the 32-row blocks, q the code (signed for Q8_B32T2)."""
    codes = w.planes["data"]
    q = codes.view(torch.int8) if get_format(w.format).signed else codes
    return _code_matmul_plain(x, w, q.float())


def wire_matmul_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """B4's wire mode, the single-plane tile with pk = 8 / bits codes per
    byte (stream_mm, decode_step.py:584-615): byte row r of the (K_s/pk, N)
    ``data`` plane holds K rows r*pk + s in bits [bits*s, bits*s + bits);
    the codes are unsigned and every format that takes the mode carries
    a base.  _code_matmul_plain's arithmetic."""
    bits = get_format(w.format).planes[0].bits
    return _code_matmul_plain(x, w, _unpack_plane(w.planes["data"],
                                                  bits).float())


def pair8_matmul_plain(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """B4 mode (h), Q3H's pair8 tile (stream_mm, decode_step.py:511-536):
    byte row r of the (K_s/2, N) ``pair8`` plane holds v0 + 11*v1 with v0
    the value of K row 2r and v1 that of K row 2r+1 (v1 = floor((v + 0.5)
    / 11), exact for every byte); _code_matmul_plain's arithmetic."""
    return _code_matmul_plain(x, w, pair8_values(w.planes[PAIR8_PLANE])
                              .float())


def _product_f32(x: torch.Tensor, w) -> torch.Tensor:
    """One product of the fused step in its weight's mode, float32."""
    if isinstance(w, Int8MXUTensor):
        y = _i8mm_f32(x, w)
    elif I4_PLANE in w.planes:
        y = (i4_bf16_matmul_plain if i4_dot_mode() == "i4bf16"
             else i4x8_matmul_plain)(x, w)
    elif PAIR8_PLANE in w.planes:
        y = pair8_matmul_plain(x, w)
    elif get_format(w.format).planes[0].bits < 8:
        y = wire_matmul_plain(x, w)
    else:
        y = byte_matmul_plain(x, w)
    return y


def _biased(y: torch.Tensor, bias) -> torch.Tensor:
    """A product's float32 output plus its output bias (mode (d)), if
    any."""
    return y if bias is None else y + bias.float()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(t: torch.Tensor) -> int:
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def _lib():
    lib = _build.load("decode_step")
    if not getattr(lib, "_ift_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ift_i8mm_gemv.argtypes = [vp] * 6 + [i] * 4 + [vp]
        lib.ift_i8mm_gemv.restype = ctypes.c_int
        lib.ift_i4x8_gemv.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.ift_i4x8_gemv.restype = ctypes.c_int
        lib.ift_i4bf16_gemv.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.ift_i4bf16_gemv.restype = ctypes.c_int
        lib.ift_code_gemv.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.ift_code_gemv.restype = ctypes.c_int
        lib.ift_gemv_splits.argtypes = [i] * 5
        lib.ift_gemv_splits.restype = ctypes.c_int
        lib.ift_i4bf16_inflight.argtypes = [i] * 6
        lib.ift_i4bf16_inflight.restype = ctypes.c_int
        lib.ift_i4bf16_registers.argtypes = [i] * 2
        lib.ift_i4bf16_registers.restype = ctypes.c_int
        lib.ift_fused_decode_step.argtypes = (
            [ctypes.POINTER(vp), i] + [vp] * 21 + [i] * 16 + [f, f, i, vp])
        lib.ift_fused_decode_step.restype = ctypes.c_int
        lib.ift_moe_route.argtypes = [vp] * 6 + [i] * 5 + [f, vp]
        lib.ift_moe_route.restype = ctypes.c_int
        lib._ift_typed = True
    return lib


def _check_i8(w: Int8MXUTensor, name: str, k: int, n: int,
              lead: tuple = ()) -> None:
    _build.check_operand(w.data, f"{name}.data", torch.int8, lead + (k, n),
                         align=4)
    _build.check_operand(w.scale, f"{name}.scale", torch.float32,
                         lead + (n,), align=4)


def i8mm_gemv_cuda(x2: torch.Tensor, w: Int8MXUTensor) -> torch.Tensor:
    """Launch the int8 GEMV on (M <= 8, K) bf16 rows; returns (M, N)
    float32 (row quantization and scales applied)."""
    _build.require_hopper(x2)
    m, k = x2.shape
    n = int(w.shape[-1])
    if not 1 <= m <= _MAX_GEMV_ROWS:
        raise ValueError(f"i8mm_gemv takes 1..{_MAX_GEMV_ROWS} rows, got {m}")
    if k % 4 or n % 4:
        raise ValueError(f"i8mm_gemv needs K and N multiples of 4, "
                         f"got K={k} N={n}")
    _build.check_operand(x2, "x", torch.bfloat16, (m, k))
    _check_i8(w, "w", k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    tiles = -(-n // _TILE_COLS)
    work = torch.zeros(m * n + tiles, dtype=torch.int32, device=x2.device)
    lib = _lib()
    rc = lib.ift_i8mm_gemv(_build.ptr(x2), _build.ptr(w.data),
                           _build.ptr(w.scale), _build.ptr(out),
                           _build.ptr(work), _build.ptr(work[m * n:]),
                           m, k, n, _sms(x2), _build.stream_of(x2))
    _build.check(lib, rc, GEMV_KERNEL)
    _build.launch_counts[GEMV_KERNEL] += 1
    return out


def _i4_geometry(w: QuantizedTensor, mode: str = "i4") -> tuple:
    """(csrc WeightMode, step launch count, GEMV launch count) of an i4
    weight's geometry (its format's block and metadata type) in the i4
    layout's mode `mode`: "i4" (i4x8) or "i4bf16" (b')."""
    key = (get_format(w.format).block, w.scale.dtype)
    table = _I4_FAMILIES[mode]
    if key not in table:
        raise NotImplementedError(
            f"the i4 GEMVs take blocks of 64, 32 or 16 rows with f16 or "
            f"f32 metadata as the 4-bit formats store them, not {key} "
            f"({w.format})")
    return table[key]


def _check_i4(w: QuantizedTensor, name: str, k: int, n: int,
              lead: tuple = ()) -> None:
    """An i4x8 operand: data_i4p (K/2, N) uint8, block scale and base
    (K/block, N) of one type (f16, or f32 for Q4_B32T2 and Q4_B16), each
    with the leading axes `lead` (an expert stack's)."""
    blk = get_format(w.format).block
    _i4_geometry(w)
    if k % blk:
        raise ValueError(f"{name}: K={k} is not a multiple of the block "
                         f"{blk}")
    _build.check_operand(w.planes[I4_PLANE], f"{name}.{I4_PLANE}",
                         torch.uint8, lead + (k // 2, n))
    for part, t in (("scale", w.scale), ("base", w.base)):
        _build.check_operand(t, f"{name}.{part}", w.scale.dtype,
                             lead + (k // blk, n))


@functools.lru_cache(maxsize=None)
def _gemv_splits(k: int, n: int, glu: bool, sms: int, mode: int = 1) -> int:
    """The most K splits the GEMV of weight mode `mode` (csrc WeightMode;
    the i4x8 GEMV by default) takes for (K, N) weights at any row count
    (the i4x8 GEMV plans one row on its dp4a loop and 2..8 on the walk)."""
    splits = _lib().ift_gemv_splits(k, n, int(glu), mode, sms)
    if splits < 1:
        raise ValueError(f"the GEMV of weight mode {mode} does not take "
                         f"K={k} N={n}")
    return splits


def _i4_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor,
                  mode: str) -> torch.Tensor:
    """Launch one of the i4 layout's GEMVs alone (mode "i4": i4x8, "i4bf16":
    (b')) on (M <= 8, K_s) bf16 rows, in the instantiation of w's geometry;
    returns (M, N) float32."""
    _build.require_hopper(x2)
    m, k = x2.shape
    n = int(w.shape[-1])
    code, _, counter = _i4_geometry(w, mode)
    blk = get_format(w.format).block
    if not 1 <= m <= _MAX_GEMV_ROWS:
        raise ValueError(f"{counter} takes 1..{_MAX_GEMV_ROWS} rows, got {m}")
    if k != w.storage_k or k % blk or n % 4:
        raise ValueError(f"{counter} needs the stored K (a multiple of the "
                         f"block, {blk}) and N a multiple of 4, got K={k} "
                         f"N={n}")
    _build.check_operand(x2, "x", torch.bfloat16, (m, k))
    _check_i4(w, "w", k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    part = torch.empty(_gemv_splits(k, n, False, _sms(x2), code) * m * n,
                       dtype=torch.float32, device=x2.device)
    counters = torch.zeros(-(-n // _TILE_COLS), dtype=torch.int32,
                           device=x2.device)
    lib = _lib()
    entry = lib.ift_i4x8_gemv if mode == "i4" else lib.ift_i4bf16_gemv
    rc = entry(_build.ptr(x2), _build.ptr(w.planes[I4_PLANE]),
               _build.ptr(w.scale), _build.ptr(w.base), _build.ptr(out),
               _build.ptr(part), _build.ptr(counters), m, k, n, code,
               _sms(x2), _build.stream_of(x2))
    _build.check(lib, rc, counter)
    _build.launch_counts[counter] += 1
    return out


def i4x8_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch the i4x8 GEMV alone on (M <= 8, K_s) bf16 rows; returns (M, N)
    float32 (B4 mode (b)'s product, i4x8_matmul_plain's arithmetic), in
    the instantiation of w's geometry (launch count ``i4x8_gemv`` for
    Q4_B64T1, ``i4x8_gemv_b32``, ``_b32f`` or ``_b16f`` for Q4_B32T1A/B,
    Q4_B32T2 and Q4_B16): 2..8 rows on the int8 tensor cores (csrc
    i4x8_walk), one row on the dp4a loop."""
    return _i4_gemv_cuda(x2, w, "i4")


def i4bf16_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch the (b') GEMV alone on (M <= 8, K_s) bf16 rows; returns (M, N)
    float32 (B4 mode (b')'s product, i4_bf16_matmul_plain's arithmetic),
    in the instantiation of w's geometry (launch count ``i4bf16_gemv``
    for Q4_B64T1, ``i4bf16_gemv_b32``, ``_b32f`` or ``_b16f`` for
    Q4_B32T1A/B, Q4_B32T2 and Q4_B16)."""
    return _i4_gemv_cuda(x2, w, "i4bf16")


def i4bf16_bytes_in_flight(m: int, w: QuantizedTensor, glu: bool,
                           device) -> int:
    """The weight bytes a GEMV on the tensor-core walk ((b') for w in the
    i4 layout; the wire or pair8 GEMV for a whole-code plane) is planned
    to keep in flight per SM for m rows of w (N its w1n3 width when glu)
    on the card `device`: csrc ift_i4bf16_inflight works it out from the
    launch plan (the two CTAs an SM is launched for, at most the grid's
    share, x 8 warps x the 3 slots of 1 KB of codes a warp's cp.async ring
    holds ahead); a plan figure, not a measurement."""
    code = (_i4_geometry(w, "i4bf16") if I4_PLANE in w.planes
            else _code_geometry(w))[0]
    got = _lib().ift_i4bf16_inflight(
        m, w.storage_k, int(w.shape[-1]), int(glu), code,
        _sm_count(torch.device(device).index or 0))
    if got < 0:
        raise ValueError(f"the tensor-core GEMV does not take {w.format} "
                         f"{tuple(w.shape)} at M={m}")
    return got


def i4bf16_registers(device) -> dict:
    """The registers a thread of each tensor-core GEMV instantiation (the
    (b'), wire and pair8 modes, and the i4x8 modes' 2..8-row GEMV) takes
    on the card `device` (cudaFuncGetAttributes), by its launch count: the
    w1n3 (GLU) instantiation and the one of the other products."""
    torch.cuda.init()
    with torch.cuda.device(device):
        lib = _lib()
        return {gemv: {"w1n3": lib.ift_i4bf16_registers(code, 1),
                       "other": lib.ift_i4bf16_registers(code, 0)}
                for code, _, gemv in (
                    *_I4BF16_MODES.values(), *_WIRE_MODES.values(),
                    (_PAIR8_MODE, PAIR8_KERNEL, PAIR8_GEMV_KERNEL),
                    *_I4_MODES.values())}


def _code_geometry(w: QuantizedTensor) -> tuple:
    """A whole-code weight's (csrc WeightMode, step launch count, GEMV
    launch count, plane name, codes per byte): byte (c), the wire mode by
    (bits, block) or mode (h)."""
    fmt = get_format(w.format)
    if PAIR8_PLANE in w.planes:
        return _PAIR8_MODE, PAIR8_KERNEL, PAIR8_GEMV_KERNEL, PAIR8_PLANE, 2
    bits = fmt.planes[0].bits
    if bits == 8:
        return (_MODES["byte"] + (w.base is not None), BYTE_KERNEL,
                BYTE_GEMV_KERNEL, "data", 1)
    key = (bits, fmt.block)
    if key not in _WIRE_MODES:
        raise NotImplementedError(
            f"the wire GEMVs take 4-bit codes in blocks of 64 or 32 rows "
            f"and 2-bit codes in blocks of 32, not {key} ({w.format})")
    return _WIRE_MODES[key] + ("data", 8 // bits)


def _check_codes(w: QuantizedTensor, name: str, k: int, n: int,
                 lead: tuple = ()) -> None:
    """A whole-code operand (byte, wire or pair8): its plane (K/pk, N)
    uint8 and f16 block scales and bases (K/block, N), each with the
    leading axes `lead`; K whole blocks."""
    blk = get_format(w.format).block
    _, _, _, plane, pk = _code_geometry(w)
    if k % blk:
        raise ValueError(f"{name}: K={k} is not a multiple of the block "
                         f"{blk}")
    _build.check_operand(w.planes[plane], f"{name}.{plane}", torch.uint8,
                         lead + (k // pk, n))
    for part, t in (("scale", w.scale), ("base", w.base)):
        if t is not None:
            _build.check_operand(t, f"{name}.{part}", torch.float16,
                                 lead + (k // blk, n))


def _code_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch the byte, wire or pair8 GEMV alone on (M <= 8, K_s) bf16
    rows, in the instantiation of w's geometry; returns (M, N) float32."""
    _build.require_hopper(x2)
    m, k = x2.shape
    n = int(w.shape[-1])
    code, _, counter, plane, _ = _code_geometry(w)
    if not 1 <= m <= _MAX_GEMV_ROWS:
        raise ValueError(f"{counter} takes 1..{_MAX_GEMV_ROWS} rows, got {m}")
    if k != w.storage_k or n % 4:
        raise ValueError(f"{counter} needs the stored K and N a multiple of "
                         f"4, got K={k} N={n}")
    _build.check_operand(x2, "x", torch.bfloat16, (m, k))
    _check_codes(w, "w", k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    part = torch.empty(_gemv_splits(k, n, False, _sms(x2), code) * m * n,
                       dtype=torch.float32, device=x2.device)
    counters = torch.zeros(-(-n // _TILE_COLS), dtype=torch.int32,
                           device=x2.device)
    lib = _lib()
    rc = lib.ift_code_gemv(
        _build.ptr(x2), _build.ptr(w.planes[plane]), _build.ptr(w.scale),
        _build.ptr(w.base) if w.base is not None else ctypes.c_void_p(0),
        _build.ptr(out), _build.ptr(part), _build.ptr(counters), m, k, n,
        code, _sms(x2), _build.stream_of(x2))
    _build.check(lib, rc, counter)
    _build.launch_counts[counter] += 1
    return out


def byte_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch mode (c)'s byte GEMV alone on (M <= 8, K_s) bf16 rows of a Q8
    block weight (Q8_B32T2, or Q8_B32T1 with its base); returns (M, N)
    float32 (byte_matmul_plain's arithmetic; launch count
    ``byte_gemv``)."""
    if PAIR8_PLANE in w.planes or get_format(w.format).planes[0].bits != 8:
        raise ValueError(f"byte_gemv takes a Q8 data plane, not "
                         f"{sorted(w.planes)} ({w.format})")
    return _code_gemv_cuda(x2, w)


def wire_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch the wire-mode GEMV alone on (M <= 8, K_s) bf16 rows; returns
    (M, N) float32 (wire_matmul_plain's arithmetic), in the instantiation
    of w's geometry (launch count ``wire_gemv`` for Q4_B64T1,
    ``wire_gemv_b32`` for Q4_B32T1A/B, ``wire_gemv_q2`` for
    Q2_B32T1A/B)."""
    if (get_format(w.format).pair_base11 or "data" not in w.planes
            or get_format(w.format).planes[0].bits == 8):
        raise ValueError(f"wire_gemv takes a wire data plane, not "
                         f"{sorted(w.planes)} ({w.format})")
    return _code_gemv_cuda(x2, w)


def pair8_gemv_cuda(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Launch mode (h)'s GEMV alone on (M <= 8, K_s) bf16 rows of a Q3H
    pair8 weight; returns (M, N) float32 (pair8_matmul_plain's
    arithmetic; launch count ``pair8_gemv``)."""
    if PAIR8_PLANE not in w.planes:
        raise ValueError(f"pair8_gemv takes the {PAIR8_PLANE} plane, not "
                         f"{sorted(w.planes)} ({w.format})")
    return _code_gemv_cuda(x2, w)


def i8mm_matmul(x: torch.Tensor, w: Int8MXUTensor) -> torch.Tensor:
    """y = x @ w for an Int8MXUTensor (ops/linear.py's i8mm branch); x:
    (..., K).  CPU tensors take the plain version.  On the card up to 8
    rows take the int8 GEMV kernel; more rows (prefill) take one
    torch._int_mm over rows quantized as the plain version quantizes them
    (the JAX package leaves this product to XLA), padded to the rows it
    accepts."""
    if x.device.type == "cpu":
        return i8mm_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"i8mm_matmul: unsupported device {x.device}")
    k, n = int(w.shape[-2]), int(w.shape[-1])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m <= _MAX_GEMV_ROWS:
        if x2.dtype != torch.bfloat16:
            raise ValueError(f"i8mm_gemv takes bf16 rows, got {x2.dtype}")
        y = i8mm_gemv_cuda(x2.contiguous(), w)
    else:
        xq, xs = int8_rowwise_activations(x2)
        rows = max(_INT_MM_MIN_ROWS, m)
        rows = -(-rows // 8) * 8
        acc = torch._int_mm(F.pad(xq, (0, 0, 0, rows - m)), w.data)[:m]
        y = acc.float() * xs * w.scale
    return y.reshape(lead + (n,)).to(x.dtype)


# ----------------------------------------------------------- eligibility
def _pick_tn(kp: int, n: int) -> int:
    for tn in (512, 256, 128):
        if n % tn == 0 and 2 * kp * tn <= _WBUF_BUDGET:
            return tn
    return 0


def _mm_mode(w) -> Optional[str]:
    """How the TPU kernel would stream weight w (its `_mm_cfg`): 'i8mm';
    'i4' or 'i4bf16' (the i4 layout's data_i4p nibbles, streamed i4x8 or
    in mode (b') as INFERFLOW_I4_DOT says now: i4_dot_mode); 'pair8' (Q3H's
    byte-per-pair plane, mode (h)); 'byte' (one code per byte: the Q8
    block formats); 'wire' (sub-byte single-plane wire formats); or None
    (not fusable)."""
    if isinstance(w, Int8MXUTensor):
        kp, n = (int(s) for s in w.data.shape[-2:])
        return "i8mm" if kp % 8 == 0 and _pick_tn(kp, n) else None
    if not isinstance(w, QuantizedTensor):
        return None
    fmt = get_format(w.format)
    if I4_PLANE in w.planes:
        kp, n = (int(s) for s in w.planes[I4_PLANE].shape[-2:])
        if (2 * kp) % fmt.block or kp % 8 or not _pick_tn(kp, n):
            return None
        return i4_dot_mode()
    if fmt.pair_base11:
        plane = w.planes.get(PAIR8_PLANE)
        if plane is None or fmt.meta != "f16":
            return None
        kp, n = (int(s) for s in plane.shape[-2:])
        if (2 * kp) % fmt.block or kp % 8 or not _pick_tn(kp, n):
            return None
        return "pair8"
    if (len(fmt.planes) != 1
            or fmt.planes[0].layout != "consecutive" or fmt.meta != "f16"
            or "data" not in w.planes):
        return None
    pk = 8 // fmt.planes[0].bits
    kp, n = (int(s) for s in w.planes["data"].shape[-2:])
    k_s = kp * pk
    if k_s % fmt.block or k_s % (pk * 8) or not _pick_tn(kp, n):
        return None
    return "byte" if pk == 1 else "wire"


def _stored_k(w) -> int:
    if isinstance(w, Int8MXUTensor):
        return int(w.data.shape[-2])
    return w.storage_k


def _ffn_group(lp: dict):
    """A layer's FFN weights for the fused step: the dense ``ffn`` dict, a
    MoE layer's ``experts_stacked`` (w1n3 and w2 with a leading expert
    axis), or None."""
    moe = lp.get("moe")
    return lp.get("ffn") if moe is None else moe.get("experts_stacked")


def _moe_shape(spec, lp: dict) -> Optional[tuple]:
    """(n_exp, top_k) of a MoE layer the TPU kernel routes in its mode (g)
    (decode_step.py:1474-1493: a homogeneous expert stack, a dense 2-D gate
    without bias, no shared expert, 1 <= top_k <= min(4, n_exp)); None for
    a layer it does not take."""
    moe = lp["moe"]
    stacked = moe.get("experts_stacked")
    gate = moe.get("gate")
    if "ffn" in lp or moe.get("shared") or stacked is None \
            or "gate_b" in moe or "pre_norm" not in moe \
            or not isinstance(gate, torch.Tensor) or gate.dim() != 2:
        return None
    n_exp = int(gate.shape[-1])
    top_k = spec.hyper_params.moe_top_k or 2
    if not 1 <= top_k <= min(4, n_exp):
        return None
    if any(int(stacked[k].shape[0]) != n_exp for k in ("w1n3", "w2")
           if k in stacked):
        return None
    return n_exp, top_k


def _fusion_modes(spec, layers, cache, bsz: int) -> Optional[set]:
    """The weight modes of a configuration the TPU kernel fuses, with
    "moe" for routed MoE layers and "bias" when a product carries an
    output bias (mode (d)), else None.  Dense and paged caches both
    qualify: the TPU rule takes a pool whose pages are one lane tile,
    which every pool of runtime/paged_kv.py is.  Raises
    NotImplementedError for MoE layers of more than 64 experts."""
    if not isinstance(cache, (KVCache, PagedKVCache)) \
            or not isinstance(layers, list) or not layers:
        return None
    hp = spec.hyper_params
    if spec.norm_alg != "rms" or spec.pos_embedding_alg != "rope":
        return None
    if spec.is_parallel_attn or not spec.is_attn_post_as_residual:
        return None
    if not spec.use_self_attn_pre_norm:
        return None
    if spec.attn_out_scale != 1.0 or spec.ffn_out_scale != 1.0:
        return None
    if spec.effective_rope_dim() not in (-1, 0, None, hp.head_dim):
        return None
    if spec.activation_fn not in _ACTS:
        return None
    if bsz > 8 or not cache.quantized:
        return None
    d = cache.head_dim
    if not (d == 128 or (d < 128 and 128 % d == 0)):
        return None
    if spec.qkv_format != 1:
        return None
    modes = set()
    moe_shapes = {_moe_shape(spec, lp) if "moe" in lp else None
                  for lp in layers}
    if len(moe_shapes) != 1:
        return None  # MoE and dense layers, or differing expert counts
    moe_shape = moe_shapes.pop()
    if moe_shape is None and any("moe" in lp for lp in layers):
        return None
    if moe_shape is not None and moe_shape[0] > _MAX_EXPERTS:
        raise NotImplementedError(
            f"the fused decode step's mode (g) routes at most {_MAX_EXPERTS} "
            "experts")
    for lp in layers:
        attn, ffn = lp.get("attn", {}), _ffn_group(lp)
        fnorm = lp.get("moe", ffn or {})
        if ffn is None or "pre_norm" not in attn or "pre_norm" not in fnorm:
            return None
        if "post_norm" in attn or "post_norm" in fnorm:
            return None
        for grp, kk in ((attn, "qkv"), (attn, "wo"), (ffn, "w1n3"),
                        (ffn, "w2")):
            mode = _mm_mode(grp.get(kk))
            if mode is None:
                return None
            modes.add(mode)
            # a layer-stacked (L, N) bias in the TPU rule: one (N,) tensor
            # per layer here; on a MoE layer every expert shares it
            bias = grp.get(f"{kk}_b")
            if bias is not None:
                if not isinstance(bias, torch.Tensor) or bias.dim() != 1:
                    return None
                modes.add("bias")
        e_dim = int(attn["pre_norm"].shape[-1])
        for w, want in ((attn["qkv"], e_dim),
                        (attn["wo"], hp.decoder_heads * hp.head_dim),
                        (ffn["w1n3"], e_dim)):
            if _stored_k(w) != want:
                return None
        f_dim = int(ffn["w2"].shape[-2])
        if int(ffn["w1n3"].shape[-1]) != 2 * f_dim or f_dim % 128:
            return None
    if moe_shape is not None:
        modes.add("moe")
    return modes


def mega_mode() -> str:
    """INFERFLOW_MEGA, read at each routing decision as the TPU package
    reads it: "0" turns the fused step off (every decode step takes the
    per-layer loop), "2" forces it for every configuration it supports,
    anything else ("1", the default) routes by fused_step_preferred's
    measured rule."""
    return os.environ.get("INFERFLOW_MEGA", "1")


def fused_step_supported(spec, layers, cache, bsz: int) -> bool:
    """Static eligibility for the whole-model fused decode step (the TPU
    package's rule over this package's per-layer lists and logical caches,
    dense or paged; its TPU lane-tile rule for the cache does not apply).
    False under INFERFLOW_MEGA=0, before any other check, as there."""
    if mega_mode() == "0":
        return False
    return _fusion_modes(spec, layers, cache, bsz) is not None


def fused_step_preferred(spec, layers, cache, bsz: int) -> bool:
    """Routing on top of fused_step_supported, as the TPU package routes:
    sub-byte wire planes and Q3H pair8 keep the per-layer path (kernels
    B1 or B6, and B2); the i8mm and i4 layouts and the Q8 block formats
    (byte mode: no product streams more than one code per byte) take the
    fused step, with or without output biases.  INFERFLOW_MEGA=0 routes
    every step to the per-layer loop; INFERFLOW_MEGA=2 takes the fused
    step wherever it is supported (the wire mode and mode (h) included)."""
    mega = mega_mode()
    if mega == "0":
        return False
    modes = _fusion_modes(spec, layers, cache, bsz)
    if modes is None:
        return False
    return mega == "2" or not modes & {"wire", "pair8"}


# ------------------------------------------------------ the plain version
def _expand_cos_sin(positions: torch.Tensor, d: int, order: int,
                    base: float):
    """(B,) positions -> cos, sin (B, D) float32 with rope(x) = x * cos +
    rot(x) * sin elementwise."""
    pos = positions.reshape(-1).float()
    half = d // 2
    freq = torch.arange(half, dtype=torch.float32, device=pos.device)
    inv = torch.pow(float(base), -2.0 * freq / d)  # no host-to-device copy
    theta = pos[:, None] * inv[None, :]
    c, s = torch.cos(theta), torch.sin(theta)
    if order == 1:
        return c.repeat_interleave(2, dim=-1), s.repeat_interleave(2, dim=-1)
    return torch.cat([c, c], dim=-1), torch.cat([s, s], dim=-1)


def _rot(x: torch.Tensor, order: int) -> torch.Tensor:
    """The pair rotation: rope(x) = x * cos + _rot(x) * sin."""
    d = x.shape[-1]
    if order == 2:
        return torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    pairs = x.reshape(x.shape[:-1] + (d // 2, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(
        x.shape)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16)


def _qdq(rows: torch.Tensor, blk: int) -> torch.Tensor:
    """The KV codec's quantize -> dequantize of the step's own rows, with
    the float32 scale (the self term; the cache keeps the f16 one)."""
    shape = rows.shape
    xb = rows.reshape(shape[:-1] + (shape[-1] // blk, blk))
    sc = true_div(xb.abs().amax(dim=-1, keepdim=True), 127.0)
    inv = torch.where(sc >= 1e-5,
                      1.0 / torch.where(sc == 0, torch.ones_like(sc), sc),
                      torch.zeros_like(sc))
    q = torch.round(xb * inv).clamp(-128, 127)
    return (q * sc).reshape(shape)


def _glu(a: torch.Tensor, g: torch.Tensor, act: str) -> torch.Tensor:
    """bf16(act(a) * g) in float32 arithmetic."""
    if act == "silu":
        av = a * torch.sigmoid(a)
    elif act == "gelu":
        av = F.gelu(a, approximate="tanh")
    else:
        av = torch.relu(a)
    return (av * g).to(torch.bfloat16)


def _cache_walk(s: int, d: int) -> tuple:
    """(positions per tile, parities) of the TPU kernel's cache walk: its
    packed cache holds pf = 128/D consecutive rows per storage row, and
    each tile of ts storage rows is taken in pf online-softmax steps, one
    per position parity (t % pf)."""
    pf = 128 // d if d < 128 and 128 % d == 0 else 1
    ts = next((t for t in (512, 256, 128) if (s // pf) % t == 0), s // pf)
    return ts * pf, pf


def _walk_rows(cache, layer: int, lengths: torch.Tensor):
    """The rows the TPU kernel walks for `layer`: codes and scales as
    (B, H, S, ·) tensors, and the walk's (positions per tile, parities),
    over the tiles that cover the longest slot.  A tile past a slot's
    length adds exactly nothing (p = 0 and alpha = 1; for an empty slot
    the self row's alpha = 0 discards whatever the walk summed), so the
    TPU kernel's walk over every tile gives the same result.  Dense: tiles
    of ts x pf positions (_cache_walk).  Paged: one page per tile, as the
    TPU kernel's page walk takes it, gathered through the page table."""
    longest = int(lengths.max()) if lengths.numel() else 0
    if isinstance(cache, PagedKVCache):
        n = min(max(-(-longest // cache.page_tokens), 1),
                cache.max_pages_per_slot)
        src = tuple(cache._gather(a, layer, n) for a in
                    (cache.k, cache.v, cache.k_scale, cache.v_scale))
        return src, cache.page_tokens, kv_pack_for(cache.head_dim)
    span, pf = _cache_walk(cache.max_len, cache.head_dim)
    rows = min(max(-(-longest // span), 1) * span, cache.max_len)
    src = tuple(a[layer, :, :, :rows] for a in
                (cache.k, cache.v, cache.k_scale, cache.v_scale))
    return src, span, pf


def _attend_plain(q, k_self, v_self, cache, layer: int,
                  lengths: torch.Tensor, scale: float, batched: bool):
    """q (B, Hq, D) float32 (roped); k_self/v_self (B, H, D) the step's
    quantize-dequantized rows.  Online softmax over cache rows
    [0, lengths[b]) of `layer`, in the TPU kernel's walk order (so that
    the batched mode's bf16 roundings of p * vscale, relative to the
    running maximum, fall where they fall there), then the self row.
    Returns ctx (B, Hq * D) bf16."""
    bsz, hq, d = q.shape
    hk = cache.kv_heads
    g = hq // hk
    blk = cache.block
    nblk = d // blk
    qh = q.reshape(bsz, hk, g, d)
    s_self = (qh * k_self[:, :, None, :]).sum(-1) * scale  # (B, H, g)
    # the batched mode's cache dots take bf16 q and bf16 p * vscale
    qc = qh.to(torch.bfloat16).float() if batched else qh
    lengths = lengths.to(device=q.device, dtype=torch.long)
    m = torch.full((bsz, hk, g), NEG_INF, device=q.device)
    l = torch.zeros((bsz, hk, g), device=q.device)
    acc = torch.zeros((bsz, hk, g, d), device=q.device)
    (k_all, v_all, ks_all, vs_all), span, pf = _walk_rows(cache, layer,
                                                          lengths)
    s = k_all.shape[2]
    pos_all = torch.arange(s, device=q.device)
    for t0 in range(0, s, span):
        for par in range(pf):
            rows = slice(t0 + par, min(t0 + span, s), pf)
            kc = k_all[:, :, rows].float()  # (B, H, T, D) codes
            vc = v_all[:, :, rows].float()
            ks = ks_all[:, :, rows].float()  # (B, H, T, C)
            vs = vs_all[:, :, rows].float()
            scores = None
            for c in range(nblk):
                sl = slice(c * blk, (c + 1) * blk)
                part = torch.matmul(qc[..., sl], kc[..., sl].transpose(-1, -2)) \
                    * ks[..., c][:, :, None, :]
                scores = part if scores is None else scores + part
            scores = scores * scale
            valid = pos_all[rows][None, :] < lengths[:, None]  # (B, T)
            scores = torch.where(valid[:, None, None, :], scores,
                                 torch.full_like(scores, NEG_INF))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)
            parts = []
            for c in range(nblk):
                pc = p * vs[..., c][:, :, None, :]
                if batched:
                    pc = pc.to(torch.bfloat16).float()
                parts.append(alpha[..., None] * acc[..., c * blk:(c + 1) * blk]
                             + torch.matmul(pc, vc[..., c * blk:(c + 1) * blk]))
            acc = torch.cat(parts, dim=-1)
            m = m_new
    m_new = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_new)
    p_self = torch.exp(s_self - m_new)
    l = alpha * l + p_self
    ctx = (alpha[..., None] * acc + p_self[..., None] * v_self[:, :, None, :]) \
        / torch.clamp(l, min=1e-30)[..., None]
    return ctx.to(torch.bfloat16).reshape(bsz, hq * d)


def _add_bf16(xres: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (xres.float() + y.to(torch.bfloat16).float()).to(torch.bfloat16)


def moe_route_plain(xn: torch.Tensor, gate: torch.Tensor, top_k: int,
                    norm_topk: bool):
    """Mode (g)'s routing (the TPU kernel's moe_slot,
    decode_step.py:1105-1151): logits = f32(xn) @ f32(gate), softmax, top_k
    by repeated argmax (ties to the lower expert), each chosen probability
    divided by their sum (added in order) when norm_topk.  xn: (B, E) bf16;
    gate: (E, n_exp).  Returns (experts (B, top_k) int32, weights (B,
    top_k) float32)."""
    logits = torch.matmul(xn.float(), gate.float())
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    masked = probs.clone()
    rows = torch.arange(probs.shape[0], device=probs.device)
    sel, vals = [], []
    for _ in range(top_k):
        e = torch.argmax(masked, dim=-1)  # the first of equal maxima
        sel.append(e)
        vals.append(masked[rows, e])
        masked[rows, e] = float("-inf")
    tot = vals[0]
    for v in vals[1:]:
        tot = tot + v
    if norm_topk:
        vals = [v / tot for v in vals]
    return (torch.stack(sel, dim=-1).to(torch.int32),
            torch.stack(vals, dim=-1))


def moe_route(xres: torch.Tensor, norm_w: torch.Tensor, gate: torch.Tensor,
              top_k: int, norm_topk: bool, eps: float):
    """Mode (g)'s routing launch alone: xn = bf16(rmsnorm(xres) * norm_w),
    then moe_route_plain's function.  xres (B <= 8, E) bf16, norm_w (E,)
    bf16, gate (E, n_exp) bf16.  Returns (xn, experts (B, top_k) int32,
    weights (B, top_k) float32).  CPU tensors take the plain version."""
    if xres.device.type == "cpu":
        xn = _rmsnorm(xres, norm_w, eps)
        return (xn,) + moe_route_plain(xn, gate, top_k, norm_topk)
    if xres.device.type != "cuda":
        raise ValueError(f"moe_route: unsupported device {xres.device}")
    _build.require_hopper(xres)
    bsz, e = xres.shape
    n_exp = int(gate.shape[-1])
    if not 1 <= bsz <= _MAX_GEMV_ROWS or not 1 <= top_k <= min(4, n_exp) \
            or n_exp > _MAX_EXPERTS:
        raise ValueError(f"moe_route takes 1..{_MAX_GEMV_ROWS} rows, "
                         f"1..{_MAX_EXPERTS} experts and top_k <= 4, got "
                         f"B={bsz} experts={n_exp} top_k={top_k}")
    _build.check_operand(xres, "xres", torch.bfloat16, (bsz, e))
    _build.check_operand(norm_w, "norm_w", torch.bfloat16, (e,))
    _build.check_operand(gate, "gate", torch.bfloat16, (e, n_exp))
    dev = xres.device
    xn = torch.empty((bsz, e), dtype=torch.bfloat16, device=dev)
    sel = torch.empty((bsz, top_k), dtype=torch.int32, device=dev)
    weights = torch.empty((bsz, top_k), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.ift_moe_route(_build.ptr(xres), _build.ptr(norm_w),
                           _build.ptr(gate), _build.ptr(xn),
                           _build.ptr(sel), _build.ptr(weights), bsz, e,
                           n_exp, top_k, int(norm_topk), eps,
                           _build.stream_of(xres))
    _build.check(lib, rc, ROUTE_KERNEL)
    _build.launch_counts[ROUTE_KERNEL] += 1
    return xn, sel, weights


def _moe_ffn_plain(spec, moe: dict, xres: torch.Tensor,
                   record: Optional[dict] = None) -> torch.Tensor:
    """Mode (g)'s FFN: route every slot, then per slot b and choice j in
    order, y = W2_e(GLU(W1n3_e(xn_b))) and xres_b = bf16(xres_b + bf16(y *
    v_j)), each product in the experts' weight mode plus the bias the
    experts share, if any.  Each chosen expert
    runs once on the slots that chose it (its rows do not depend on one
    another).  record: a dict of lists that receives the routing (experts,
    weights, the probabilities)."""
    hp = spec.hyper_params
    stacked = moe["experts_stacked"]
    top_k = hp.moe_top_k or 2
    xn = _rmsnorm(xres, moe["pre_norm"], spec.norm_eps)
    sel, vals = moe_route_plain(xn, moe["gate"], top_k,
                                bool(hp.moe_norm_top_k_prob))
    if record is not None:
        record["experts"].append(sel)
        record["weights"].append(vals)
        record["probs"].append(torch.softmax(
            torch.matmul(xn.float(), moe["gate"].float()), dim=-1))
    ys = torch.empty(sel.shape + (xres.shape[-1],), dtype=torch.float32,
                     device=xres.device)
    for e in sorted(set(sel.flatten().tolist())):
        slots, js = (sel == e).nonzero(as_tuple=True)
        w1n3, w2 = (stacked[k].select(e) for k in ("w1n3", "w2"))
        h2 = _biased(_product_f32(xn[slots], w1n3), stacked.get("w1n3_b"))
        f_dim = h2.shape[-1] // 2
        ys[slots, js] = _biased(_product_f32(
            _glu(h2[:, :f_dim], h2[:, f_dim:], spec.activation_fn), w2),
            stacked.get("w2_b"))
    for j in range(top_k):
        xres = _add_bf16(xres, ys[:, j] * vals[:, j:j + 1])
    return xres


def fused_decode_step_plain(spec, layers: list, x: torch.Tensor,
                            positions: torch.Tensor, cache,
                            routes: Optional[list] = None):
    """The plain version: the TPU kernel's phases layer by layer, each
    product in its weight's mode plus its output bias (mode (d)) before
    the qkv split, the residual add or the GLU (a K-padded w2 takes hglu
    with a zero tail; a MoE layer's FFN routed as mode (g),
    _moe_ffn_plain), then
    append_rows_all_layers (append_rows_all_layers_paged for a
    paged cache).  routes: see fused_decode_step; the plain version also
    records each layer's input ("inputs", (L, B, E)) and routing
    probabilities ("probs", (L, B, n_exp)).  Returns (x (B, 1, E) bf16,
    cache)."""
    hp = spec.hyper_params
    hq, hk, d = hp.decoder_heads, hp.kv_heads, hp.head_dim
    bsz = x.shape[0]
    qdim, kvdim = hq * d, hk * d
    xres = x[:, 0].to(torch.bfloat16)
    cos, sin = _expand_cos_sin(positions[:, 0], d, spec.rope_order,
                               spec.rope_theta)
    cos, sin = cos[:, None, :], sin[:, None, :]
    scale = (1.0 / (d ** 0.5)) * spec.kq_scale
    order, blk, batched = spec.rope_order, cache.block, bsz > 1
    k_new, v_new = [], []
    record = None if routes is None or "moe" not in layers[0] else \
        {"experts": [], "weights": [], "inputs": [], "probs": []}
    for layer, lp in enumerate(layers):
        attn, ffn = lp["attn"], lp.get("ffn")
        if record is not None:
            record["inputs"].append(xres)
        qkv = _biased(_product_f32(
            _rmsnorm(xres, attn["pre_norm"], spec.norm_eps), attn["qkv"]),
            attn.get("qkv_b"))
        q = qkv[:, :qdim].reshape(bsz, hq, d)
        k = qkv[:, qdim:qdim + kvdim].reshape(bsz, hk, d)
        v = qkv[:, qdim + kvdim:].reshape(bsz, hk, d)
        q = q * cos + _rot(q, order) * sin
        k = k * cos + _rot(k, order) * sin
        k_new.append(k)
        v_new.append(v)
        ctx = _attend_plain(q, _qdq(k, blk), _qdq(v, blk), cache, layer,
                            cache.length, scale, batched)
        xres = _add_bf16(xres, _biased(_product_f32(ctx, attn["wo"]),
                                       attn.get("wo_b")))
        if "moe" in lp:
            xres = _moe_ffn_plain(spec, lp["moe"], xres, record)
            continue
        h2 = _biased(_product_f32(
            _rmsnorm(xres, ffn["pre_norm"], spec.norm_eps), ffn["w1n3"]),
            ffn.get("w1n3_b"))
        f_dim = h2.shape[-1] // 2
        hglu = _glu(h2[:, :f_dim], h2[:, f_dim:], spec.activation_fn)
        xres = _add_bf16(xres, _biased(_product_f32(hglu, ffn["w2"]),
                                       ffn.get("w2_b")))
    append = append_rows_all_layers_paged \
        if isinstance(cache, PagedKVCache) else append_rows_all_layers
    append(cache, torch.stack(k_new), torch.stack(v_new), cache.length)
    if record is not None:
        routes.append({k: torch.stack(v) for k, v in record.items()})
    return xres[:, None], cache


# ------------------------------------------------------------ the kernel
# per-layer pointer tables, built once per layer list and keyed by its id.
# An entry holds weak references to the tensors whose pointers it holds (a
# list cannot be weakly referenced: its tensors are), so freeing an engine
# frees its weights; it holds only the float32 copies it made of biases
# stored in another type.  A hit must find the i4 mode the table was built
# in (it holds each product's weight mode, which INFERFLOW_I4_DOT picks
# for i4 weights: a process that sets the variable between steps gets a
# new table) and the very tensors the table points into, in order: a
# list whose id is reused, a weight replaced or a bias added or dropped
# in place all miss and rebuild.
_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_TABLE_CACHE_SIZE = 4


def _fnorm(lp: dict) -> torch.Tensor:
    """The layer's FFN pre-norm (the MoE block's for a MoE layer)."""
    return (lp.get("moe") or lp["ffn"])["pre_norm"]


def _products(lp: dict) -> tuple:
    """A layer's four products: (name, weight, whether its GEMV pairs GLU
    columns, output bias or None); a MoE layer's w1n3 and w2 are its
    expert stacks, their biases the ones the experts share."""
    attn, ffn = lp["attn"], _ffn_group(lp)
    return tuple((name, grp[name], name == "w1n3", grp.get(f"{name}_b"))
                 for grp, name in ((attn, "qkv"), (attn, "wo"),
                                   (ffn, "w1n3"), (ffn, "w2")))


def _table_tensors(layers: list) -> list:
    """Every tensor whose pointer the step's table holds (a bias as the
    caller stores it), and a None per product without a bias."""
    out = []
    for lp in layers:
        out += [lp["attn"]["pre_norm"], _fnorm(lp)]
        if "moe" in lp:
            out.append(lp["moe"]["gate"])
        for _, w, _, bias in _products(lp):
            if isinstance(w, Int8MXUTensor):
                out += [w.data, w.scale]
            else:
                out += [*w.planes.values(), w.scale]
                out += [] if w.base is None else [w.base]
            out.append(bias)
    return out


def _cached_table(layers: list):
    hit = _TABLES.get(id(layers))
    if hit is None:
        return None
    mode, refs, entry = hit
    if mode != i4_dot_mode():
        return None
    now = _table_tensors(layers)
    if len(now) == len(refs) and all(
            (t is None) if r is None else (r() is t)
            for r, t in zip(refs, now)):
        return entry
    return None


def _expert_strides(w) -> list:
    """Bytes from one expert of a stack to the next: codes, scale, base."""
    if isinstance(w, Int8MXUTensor):
        parts = (w.data, w.scale, None)
    else:
        plane = next(p for p in (I4_PLANE, PAIR8_PLANE, "data")
                     if p in w.planes)
        parts = (w.planes[plane], w.scale, w.base)
    return [0 if t is None else t.stride(0) * t.element_size()
            for t in parts]


def _bias_f32(bias, name: str, n: int, device, keep: list) -> int:
    """The device pointer of a product's float32 output bias (N,), or 0
    for none; a bias of another type or layout is copied (the copy goes
    to `keep`, which the table entry holds)."""
    if bias is None:
        return 0
    b32 = bias.to(device=device, dtype=torch.float32).contiguous()
    if b32 is not bias:
        keep.append(b32)
    _build.check_operand(b32, f"{name}_b", torch.float32, (n,), align=4)
    return b32.data_ptr()


def _layer_table(layers: list, e: int, qdim: int, nqkv: int, f: int):
    """The C step's per-layer table (anorm, fnorm, then per product its
    mode, stored K and (data, scale, base) pointers, then the gate of a
    MoE layer (or null) and the byte strides between experts of w1n3 and
    w2, then each product's float32 bias (or null): csrc kTableStride),
    w2's stored K (hglu's row length, one for all layers), the (K, N,
    GLU, mode, routed) shapes of the float-mode (every mode but i8mm)
    products and the modes' step launch counts, whether any product has a
    bias, built once per layer list."""
    entry = _cached_table(layers)
    if entry is not None:
        return entry
    ptrs, float_shapes, names, keep, biased = [], set(), set(), [], False
    f_s = _stored_k(_ffn_group(layers[0])["w2"])
    dev = layers[0]["attn"]["pre_norm"].device
    for lp in layers:
        moe = lp.get("moe")
        lead = () if moe is None else (int(moe["gate"].shape[-1]),)
        for name, t in (("attn.pre_norm", lp["attn"]["pre_norm"]),
                        ("ffn.pre_norm", _fnorm(lp))):
            _build.check_operand(t, name, torch.bfloat16, (e,))
            ptrs.append(t.data_ptr())
        if _stored_k(_ffn_group(lp)["w2"]) != f_s:
            raise ValueError("the fused step takes one stored K of w2 "
                             "across its layers")
        biases = []
        for (name, w, glu, bias), k, n in zip(_products(lp), (e, qdim, e, f_s),
                                              (nqkv, e, 2 * f, e)):
            routed = name in ("w1n3", "w2") and moe is not None
            ld = lead if routed else ()
            biases.append(_bias_f32(bias, name, n, dev, keep))
            biased |= bias is not None
            mode = _mm_mode(w)
            if mode == "i8mm":
                _check_i8(w, name, k, n, ld)
                names.add(KERNEL)
                ptrs += [_MODES[mode], k, w.data.data_ptr(),
                         w.scale.data_ptr(), 0]
                continue
            if mode in _I4_FAMILIES:
                _check_i4(w, name, k, n, ld)
                code, step = _i4_geometry(w, mode)[:2]
                plane = w.planes[I4_PLANE]
            else:
                _check_codes(w, name, k, n, ld)
                code, step, _, plane, _ = _code_geometry(w)
                plane = w.planes[plane]
            names.add(step)
            float_shapes.add((k, n, glu, code, routed))
            ptrs += [code, k, plane.data_ptr(), w.scale.data_ptr(),
                     0 if w.base is None else w.base.data_ptr()]
        if moe is None:
            ptrs += [0] * 7
        else:
            _build.check_operand(moe["gate"], "moe.gate", torch.bfloat16,
                                 (e, lead[0]))
            stacked = moe["experts_stacked"]
            ptrs += [moe["gate"].data_ptr(),
                     *_expert_strides(stacked["w1n3"]),
                     *_expert_strides(stacked["w2"])]
        ptrs += biases
    entry = ((ctypes.c_void_p * len(ptrs))(*ptrs), f_s,
             frozenset(float_shapes), frozenset(names), biased, keep)
    _TABLES[id(layers)] = (
        i4_dot_mode(), [None if t is None else weakref.ref(t)
                        for t in _table_tensors(layers)], entry)
    _TABLES.move_to_end(id(layers))
    while len(_TABLES) > _TABLE_CACHE_SIZE:
        _TABLES.popitem(last=False)
    return entry


# the step's launch count by the modes of its products: the first of
# these that the step takes names it (a MoE step is counted as such)
_STEP_NAME_ORDER = (PAIR8_KERNEL, WIRE_KERNEL, WIRE_KERNEL + "_b32",
                    WIRE_KERNEL + "_q2", BYTE_KERNEL) + tuple(
    step for table in _I4_FAMILIES.values()
    for _, step, _ in sorted(table.values())) + (KERNEL,)


def fused_decode_step_cuda(spec, layers: list, x: torch.Tensor,
                           positions: torch.Tensor, cache,
                           routes: Optional[list] = None):
    """Launch kernel B4: one C call for the whole step, over a dense cache
    or (mode (f)) a page pool; MoE layers in mode (g).  routes: see
    fused_decode_step."""
    _build.require_hopper(x)
    hp = spec.hyper_params
    hq, hk, d = hp.decoder_heads, hp.kv_heads, hp.head_dim
    bsz, e = x.shape[0], x.shape[-1]
    paged = isinstance(cache, PagedKVCache)
    if paged:
        num_layers, pages, h, pt, cd = cache.k.shape
        cb, maxp = cache.page_table.shape
        s = maxp * pt
        _build.check_operand(cache.page_table, "page_table", torch.int32,
                             (cb, maxp), align=4)
        table_ptr = _build.ptr(cache.page_table)
    else:
        num_layers, cb, h, s, cd = cache.k.shape
        pages = pt = maxp = 0
        table_ptr = ctypes.c_void_p(0)
    f = int(_ffn_group(layers[0])["w2"].shape[-2])
    if hq // hk > _MAX_ROWS or d > _MAX_D or d % 16:
        raise NotImplementedError(
            f"the fused step kernel takes at most {_MAX_ROWS} query heads "
            f"per kv head and head_dim a multiple of 16 up to {_MAX_D}")
    if (cb, h, cd) != (bsz, hk, d) or num_layers != len(layers):
        raise ValueError(f"cache {tuple(cache.k.shape)} does not match "
                         f"{len(layers)} layers, B={bsz}, H={hk}, D={d}")
    moe = "moe" in layers[0]
    n_exp = int(layers[0]["moe"]["gate"].shape[-1]) if moe else 0
    top_k = (hp.moe_top_k or 2) if moe else 0
    nqkv = (hq + 2 * hk) * d
    table, f_s, float_shapes, names, biased, _ = _layer_table(
        layers, e, hq * d, nqkv, f)
    shape = tuple(cache.k.shape)
    sshape = tuple(cache.k_scale.shape)
    for name, t, dt, shp in (("k", cache.k, torch.int8, shape),
                             ("v", cache.v, torch.int8, shape),
                             ("k_scale", cache.k_scale, torch.float16, sshape),
                             ("v_scale", cache.v_scale, torch.float16, sshape)):
        _build.check_operand(t, name, dt, shp)
    dev = x.device
    xres = x.reshape(bsz, e).to(torch.bfloat16).contiguous().clone()
    lengths = cache.length.to(device=dev, dtype=torch.int32).contiguous()
    cos, sin = _expand_cos_sin(positions.reshape(-1), d, spec.rope_order,
                               spec.rope_theta)
    cos, sin = cos.contiguous(), sin.contiguous()
    # mode (g): the FFN's rows are the (slot, choice) pairs, B * top_k
    rk = bsz * top_k
    # one zeroed buffer: the i8mm split-K workspace, tile counters (one
    # set per expert in mode (g)), per-layer row maxima of ctx and hglu
    # (and of mode (g)'s hglu rows), the attention's split counters
    n_ws = max(bsz * max(nqkv, e, 2 * f), rk * max(2 * f, e))
    tiles = -(-max(nqkv, e, f) // _TILE_COLS) * max(n_exp, 1)
    # the i4x8 and byte GEMVs' float split partials: the most any one of
    # them needs (they run one after another)
    n_part = max((_gemv_splits(k, n, glu, _sms(x), mode)
                  * (rk if routed else bsz) * n
                  for k, n, glu, mode, routed in float_shapes), default=1)
    gemv_part = torch.empty(n_part, dtype=torch.float32, device=dev)
    n_amax = 2 * num_layers * bsz + num_layers * rk
    work = torch.zeros(n_ws + tiles + n_amax + bsz * hk, dtype=torch.int32,
                       device=dev)
    part = torch.empty(bsz * hk * _MAX_SPLIT * (hq // hk) * (d + 2),
                       dtype=torch.float32, device=dev)
    qkv = torch.empty((bsz, nqkv), dtype=torch.float32, device=dev)
    ctx = torch.empty((bsz, hq * d), dtype=torch.bfloat16, device=dev)
    # w2's stored K wide: the tail past F stays zero (K-padded w2); mode
    # (g) keeps one row per (slot, choice)
    hglu = (torch.zeros if f_s != f else torch.empty)(
        (max(bsz, rk), f_s), dtype=torch.bfloat16, device=dev)
    # mode (g): xn (B, E) bf16, each layer's routing (the expert of each
    # of the B * top_k rows, int32) and choice weights (float32), and the
    # expert outputs (B * top_k, E) float32
    xn = torch.empty((bsz, e) if moe else (1,), dtype=torch.bfloat16,
                     device=dev)
    route = torch.empty(max(num_layers * rk, 1), dtype=torch.int32,
                        device=dev)
    moe_f32 = torch.empty(max(num_layers * rk + rk * e, 1),
                          dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.ift_fused_decode_step(
        table, num_layers, _build.ptr(xres), _build.ptr(lengths),
        _build.ptr(cos), _build.ptr(sin), _build.ptr(cache.k),
        _build.ptr(cache.v), _build.ptr(cache.k_scale),
        _build.ptr(cache.v_scale), table_ptr, _build.ptr(qkv),
        _build.ptr(ctx), _build.ptr(hglu), _build.ptr(work),
        _build.ptr(gemv_part), _build.ptr(work[n_ws:]),
        _build.ptr(work[n_ws + tiles:]),
        _build.ptr(part), _build.ptr(work[n_ws + tiles + n_amax:]),
        _build.ptr(xn), _build.ptr(route), _build.ptr(moe_f32), bsz, e,
        hq, hk, d, s, cache.block, f, spec.rope_order,
        _ACTS[spec.activation_fn], pt, maxp, pages, n_exp, top_k,
        int(bool(hp.moe_norm_top_k_prob)), spec.norm_eps,
        (1.0 / (d ** 0.5)) * spec.kq_scale, _sms(x), _build.stream_of(x))
    name = MOE_KERNEL if moe else next(n for n in _STEP_NAME_ORDER
                                       if n in names)
    _build.check(lib, rc, name)
    _build.launch_counts[name] += 1
    if biased:
        _build.launch_counts[BIAS_KERNEL] += 1
    if routes is not None and moe:
        routes.append({
            "experts": route.view(num_layers, bsz, top_k),
            "weights": moe_f32[:num_layers * rk].view(num_layers, bsz,
                                                      top_k)})
    return xres[:, None], cache


def fused_decode_step(spec, layers: list, x: torch.Tensor,
                      positions: torch.Tensor, cache: KVCache,
                      routes: Optional[list] = None):
    """One decode step over all layers (inferflow_tpu signature), each
    product in its weight's mode (i8mm, i4x8 or (b') as INFERFLOW_I4_DOT
    says, byte, wire or pair8) plus its output bias, MoE layers routed in
    mode (g).

    x: (B, 1, E) bf16 after the embedding; positions: (B, 1), the slots'
    cache lengths; cache: a Q8 KVCache or PagedKVCache.  Returns (x (B, 1,
    E), cache) with the step's K/V rows written at each slot's length
    (through the page table for a paged cache); cache.length is not
    advanced.  routes: for MoE layers, a list that receives a dict of
    each layer's routing, "experts" (L, B, top_k) int32 and "weights" (L,
    B, top_k) float32 (for inspection; nothing else changes)."""
    if not _fusion_modes(spec, layers, cache, x.shape[0]):
        raise NotImplementedError(
            "fused_decode_step serves the configurations "
            "fused_step_supported admits; this one is not among them")
    if x.device.type == "cpu":
        return fused_decode_step_plain(spec, layers, x, positions, cache,
                                       routes)
    if x.device.type == "cuda":
        return fused_decode_step_cuda(spec, layers, x, positions, cache,
                                      routes)
    raise ValueError(f"fused_decode_step: unsupported device {x.device}")
