"""PyTorch quantize/dequantize for the block formats, and the KV-cache codec.

Port of inferflow_tpu/quant/codec_jax.py: the same arithmetic in float32 on
any torch device, so ``quantize`` gives the same bytes as the JAX codec.

Covered: every block format of formats.py, in its wire planes: the
consecutive layout (value k in byte k//p at bit (k%p)*bits) of the
Q8/Q6/Q5/Q4/Q3/Q2 families and Q3H, and Q5_B32T1's split-nibble low
plane (byte r of a block holds value r in its low nibble and value r +
block/2 in its high nibble); the ``i8mm`` device layout (``Int8MXUTensor``: per-column int8
codes for int8 x int8 products); the ``i4`` device layout (``repack_i4``:
the ``data_i4p`` plane of signed code-8 nibbles); and Q3H's ``pair8``
plane (one byte per base-11 pair code, the plane kernel B6 reads), which
``quantize`` emits directly and ``from_np`` re-packs wire planes into, as
the JAX codec does; and the q8c container (``requantize_q8_container``:
any block tensor re-encoded as Q8_B32T2), which the ``q8c`` layout applies
to every weight and the ``mixed`` layout to the FFN weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .formats import GLOBAL_TYPES, QuantFormat, get_format

I4_PLANE = "data_i4p"
PAIR8_PLANE = "pair8"


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, including the ml_dtypes bfloat16 arrays that JAX
    hands out (torch has no numpy bfloat16 type: go through the bits)."""
    a = np.array(a, copy=True)  # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@dataclasses.dataclass
class QuantizedTensor:
    """A block-quantized 2-D weight, blocks along axis 0 (K).

    planes: packed uint8 tensors by plane name (see formats.py)
    scale/base: per-block metadata, shape (K_s/block, N); f16, or f32 for
    the u8-metadata formats.  The stored K_s may exceed the logical K of
    ``shape`` (zero-scale pad blocks); see ``storage_k``.  An expert
    stack (a MoE layer's ``experts_stacked``) has a leading axis on
    ``shape`` and on every tensor: (E, K, N) codes, (E, K_s/block, N)
    metadata; ``select`` takes one expert's 2-D weight.
    """

    format: str
    shape: tuple  # logical (K, N)
    planes: dict
    scale: torch.Tensor
    base: Optional[torch.Tensor]

    @property
    def storage_k(self) -> int:
        """Stored K rows (>= logical K when the tensor was padded)."""
        return int(self.scale.shape[-2]) * get_format(self.format).block

    @property
    def nbytes(self) -> int:
        n = sum(p.numel() for p in self.planes.values())
        n += self.scale.numel() * self.scale.element_size()
        if self.base is not None:
            n += self.base.numel() * self.base.element_size()
        return n

    def select(self, i: int) -> "QuantizedTensor":
        """Entry i of the leading axis (one expert of a stack), as views."""
        return QuantizedTensor(
            self.format, tuple(self.shape[1:]),
            {k: v[i] for k, v in self.planes.items()}, self.scale[i],
            None if self.base is None else self.base[i])

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(
            self.format, self.shape,
            {k: v.to(device) for k, v in self.planes.items()},
            self.scale.to(device),
            None if self.base is None else self.base.to(device))

    @classmethod
    def from_np(cls, qt: dict, device="cuda") -> "QuantizedTensor":
        """From the JAX package's ``QuantizedTensor.to_np()`` dict, on
        `device` (the card unless the caller asks for the CPU).  Q3H wire
        planes (4 + 2 + 1 bits of each base-11 pair code) are re-packed to
        ``pair8``, one byte per pair code, as the JAX package's from_np
        does by default (codec_np.repack_pair8): the codes are unchanged."""
        device = resolve_device(device)
        fmt = get_format(qt["format"])
        planes = {k: _numpy_to_torch(v) for k, v in qt["planes"].items()}
        if fmt.pair_base11 and PAIR8_PLANE not in planes:
            planes = {PAIR8_PLANE: _codes(planes, fmt).to(torch.uint8)}
        return cls(qt["format"], tuple(int(s) for s in qt["shape"]),
                   {k: v.to(device) for k, v in planes.items()},
                   _numpy_to_torch(qt["scale"]).to(device),
                   None if qt["base"] is None
                   else _numpy_to_torch(qt["base"]).to(device))

    def to_np(self) -> dict:
        return {"format": self.format, "shape": self.shape,
                "planes": {k: v.cpu().numpy() for k, v in self.planes.items()},
                "scale": self.scale.cpu().numpy(),
                "base": None if self.base is None else self.base.cpu().numpy()}


def _unpack_plane(packed: torch.Tensor, bits: int,
                  layout: str = "consecutive", block: int = 0) -> torch.Tensor:
    """(rows, N) uint8 -> (rows*p, N) uint8 values: value k lives in byte
    k//p at bit (k%p)*bits; under 'split_half' (4 bits) byte r of each
    block holds value r in its low nibble and r + block/2 in its high.
    In uint8 arithmetic (one broadcast shift): several times faster on the
    CPU than a shift per value in int32."""
    rows, n = packed.shape
    if layout == "split_half":
        b = packed.reshape(rows * 2 // block, block // 2, n)
        return torch.cat([b & 0xF, b >> 4], dim=1).reshape(rows * 2, n)
    if bits == 8:
        return packed
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=packed.device)
    parts = (packed[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return parts.reshape(rows * (8 // bits), n)


def _codes(planes: dict, fmt: QuantFormat) -> torch.Tensor:
    """(K_s, N) int32 codes: each plane's values OR-ed in above the bits of
    the planes before it (every block format's codes fit a byte)."""
    codes = None
    shift = 0
    for pl in fmt.planes:
        part = _unpack_plane(planes[pl.name], pl.bits, pl.layout,
                             fmt.block) << shift
        codes = part if codes is None else codes | part
        shift += pl.bits
    return codes.to(torch.int32)


def _i4_format(fmt: QuantFormat) -> bool:
    """Whether the i4 layout takes the format: one unsigned 4-bit plane in
    the consecutive layout."""
    return (len(fmt.planes) == 1 and fmt.planes[0].bits == 4
            and fmt.planes[0].layout == "consecutive" and not fmt.signed)


def repack_i4(qt: QuantizedTensor) -> QuantizedTensor:
    """Device layout 'i4' (codec_jax.repack_i4): the codes re-stored as
    signed code-8 nibbles in ``data_i4p`` (uint8 (K_s/2, N)), byte row r
    holding value 2r in its low nibble and 2r+1 in its high nibble.  The
    wire plane already holds the codes in that order, and (q - 8) & 0xF is
    q ^ 8 for a 4-bit q, so the plane is the wire plane XOR 0x88 (any
    leading layer axis included).  No-op for ineligible formats."""
    if not _i4_format(get_format(qt.format)) or "data" not in qt.planes:
        return qt
    return QuantizedTensor(qt.format, qt.shape,
                           {I4_PLANE: qt.planes["data"] ^ 0x88}, qt.scale,
                           qt.base)


def i4_nibbles(plane: torch.Tensor) -> torch.Tensor:
    """(K_s/2, N) ``data_i4p`` bytes -> (K_s, N) int8 signed nibbles in
    -8..7, row 2r from the low nibble of byte row r."""
    lo = ((plane & 0xF) ^ 8).view(torch.int8) - 8
    hi = ((plane >> 4) ^ 8).view(torch.int8) - 8
    rows, n = plane.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * rows, n)


def pair8_values(pair: torch.Tensor) -> torch.Tensor:
    """(K_s/2, N) uint8 base-11 pair codes -> (K_s, N) uint8 values, row
    2j = b % 11 and row 2j+1 = b // 11 (any byte, not only the codes
    0..120).  In uint8 arithmetic (11 * (b // 11) <= 253): several times
    faster on the CPU than int32 division."""
    v1 = pair // 11
    rows, n = pair.shape
    return torch.stack([pair - 11 * v1, v1], dim=1).reshape(2 * rows, n)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Full-tensor dequantize to (K, N): w = q*scale + base in float32,
    rounded once to ``dtype``.  Mirrors codec_jax.dequantize, whose i4
    branch computes (n + 8)*scale + base from the signed nibble n, and
    whose Q3H branch splits each base-11 pair code b into row 2j = b % 11
    and row 2j+1 = b // 11."""
    fmt = get_format(qt.format)
    k, n = qt.shape[-2], qt.shape[-1]
    k_s = qt.storage_k
    # per-block metadata broadcast over the block's rows: (K_s/blk, 1, N)
    sc = qt.scale.float()[:, None, :]
    bs = None if qt.base is None else qt.base.float()[:, None, :]
    if I4_PLANE in qt.planes:
        q = i4_nibbles(qt.planes[I4_PLANE]).float() + 8.0
    elif fmt.pair_base11:
        q = pair8_values(qt.planes[PAIR8_PLANE]).float()
    else:
        q = _codes(qt.planes, fmt)
        if fmt.base_kind == "zero":
            q = torch.where(q >= 128, q - 256, q)
            bs = None
        q = q.float()
    w = q.view(k_s // fmt.block, fmt.block, n) * sc
    if bs is not None:
        w = w + bs
    w = w.reshape(k_s, n).to(dtype)
    return w[:k] if k_s != k else w


def true_div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as IEEE division on every device.  PyTorch's CUDA kernels
    multiply by the reciprocal when the divisor is a Python scalar, which
    moves some quantized codes off the reference codec's (the CPU divides);
    a 0-dim divisor on a's device takes the true division on both."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def _safe_inverse(scale: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(scale)
    return torch.where(scale >= 1e-5,
                       1.0 / torch.where(scale == 0, one, scale),
                       torch.zeros_like(scale))


def quantize(x: torch.Tensor, fmt_name: str) -> QuantizedTensor:
    """Quantize a (K, N) tensor on its device.  Byte-identical to
    codec_jax.quantize for the ported formats, on the card as on the CPU
    (every division by a constant is true_div); Q3H comes out as the
    ``pair8`` plane, as there."""
    fmt = get_format(fmt_name)
    k, n = x.shape
    if k % fmt.block:
        raise ValueError(f"K={k} is not a multiple of the block {fmt.block}")
    xb = x.float().reshape(k // fmt.block, fmt.block, n)
    vmin = xb.amin(dim=1)
    vmax = xb.amax(dim=1)

    if fmt.base_kind == "zero":
        m0 = torch.maximum(vmin.abs(), vmax.abs())
        scale = true_div(m0, fmt.scale_div)
        qf0 = xb * _safe_inverse(scale)[:, None, :]
        # C round(): half away from zero
        q = torch.trunc(qf0 + torch.copysign(torch.full_like(qf0, 0.5), qf0))
        q = q.clamp(-128, 127).to(torch.int32) & 0xFF
        planes = _pack_planes(q.reshape(k, n), fmt)
        return QuantizedTensor(fmt.name, (k, n), planes,
                               scale.to(torch.float16), None)

    base_q = vmin
    if fmt.adjust_base:
        u8 = torch.trunc(vmin * 100.0 + 100.01).to(torch.int32) & 0xFF
        base_q = true_div(u8.float(), 100.0) - 1.0
    scale = true_div(vmax - base_q, fmt.scale_div)
    inv = _safe_inverse(scale)
    stored_base = base_q + 0.5 * scale if fmt.base_kind == "mid" else base_q

    if fmt.meta == "u8":
        su8 = torch.trunc(scale * 1000.0 + 0.5).clamp(0, 255)
        scale_stored = true_div(su8, 1000.0)
        bu8 = torch.trunc(stored_base * 100.0 + 100.5).to(torch.int32) & 0xFF
        base_stored = true_div(bu8.float(), 100.0) - 1.0
    else:
        scale_stored = scale.to(torch.float16)
        base_stored = stored_base.to(torch.float16)

    qf = (xb - base_q[:, None, :]) * inv[:, None, :]
    if fmt.rounding == "half_up":
        q = torch.trunc(qf + 0.5)
    elif fmt.rounding == "trunc_eps":
        q = torch.trunc(qf + 0.0001)
    else:
        q = torch.trunc(qf + torch.copysign(torch.full_like(qf, 0.5), qf))
    if fmt.pair_base11:
        # negatives clip to 0; the device layout directly: one byte per
        # base-11 pair code
        q = q.clamp(0, fmt.max_code).to(torch.int32).reshape(k, n)
        planes = {PAIR8_PLANE: (q[0::2] + 11 * q[1::2]).to(torch.uint8)}
    else:
        # mirror the reference's uint32-cast-then-clamp: a negative offset
        # wraps and clamps to max_code (JAX codec_np.quantize_np)
        q = torch.where(q < 0, torch.full_like(q, fmt.max_code),
                        q.clamp(max=fmt.max_code))
        planes = _pack_planes(q.to(torch.int32).reshape(k, n), fmt)
    return QuantizedTensor(fmt.name, (k, n), planes, scale_stored,
                           base_stored)


def _pack_planes(codes: torch.Tensor, fmt: QuantFormat) -> dict:
    planes = {}
    shift = 0
    for pl in fmt.planes:
        part = (codes >> shift) & ((1 << pl.bits) - 1)
        shift += pl.bits
        k, n = part.shape
        if pl.layout == "split_half":
            v = part.reshape(k // fmt.block, fmt.block, n)
            half = fmt.block // 2
            planes[pl.name] = (v[:, :half] | (v[:, half:] << 4)).reshape(
                k // 2, n).to(torch.uint8)
            continue
        p = 8 // pl.bits
        v = part.reshape(k // p, p, n)
        out = torch.zeros((k // p, n), dtype=torch.int32, device=codes.device)
        for i in range(p):
            out |= v[:, i] << (i * pl.bits)
        planes[pl.name] = out.to(torch.uint8)
    return planes


def concat_quantized(parts) -> QuantizedTensor:
    """Concatenate QuantizedTensors of one format and K along N (fused qkv
    and w1|w3 weights; decoder.fuse_layer_weights), 2-D or with leading
    axes (an expert stack's (E, K, N): each expert's columns in turn)."""
    first = parts[0]
    planes = {k: torch.cat([p.planes[k] for p in parts], dim=-1)
              for k in first.planes}
    scale = torch.cat([p.scale for p in parts], dim=-1)
    base = (None if first.base is None
            else torch.cat([p.base for p in parts], dim=-1))
    n = sum(int(p.shape[-1]) for p in parts)
    return QuantizedTensor(first.format, tuple(first.shape[:-1]) + (n,),
                           planes, scale, base)


def quantize_q8_sym(x: torch.Tensor, block: int = 32):
    """Symmetric int8 quantization in blocks along the LAST axis; returns
    (int8 codes, f16 scale per block).  The KV-cache codec
    (codec_jax.quantize_q8_sym)."""
    shape = x.shape
    nb = shape[-1] // block
    xb = x.float().reshape(shape[:-1] + (nb, block))
    scale = true_div(xb.abs().amax(dim=-1), 127.0)
    q = torch.round(xb * _safe_inverse(scale)[..., None])  # half to even
    q = q.clamp(-128, 127).to(torch.int8).reshape(shape)
    return q, scale.to(torch.float16)


def dequantize_q8_sym(codes: torch.Tensor, scale: torch.Tensor,
                      block: int = 32, dtype=torch.bfloat16) -> torch.Tensor:
    shape = codes.shape
    nb = shape[-1] // block
    q = codes.float().reshape(shape[:-1] + (nb, block))
    return (q * scale.float()[..., None]).reshape(shape).to(dtype)


@dataclasses.dataclass
class Int8MXUTensor:
    """Per-COLUMN symmetric int8 weight (device_layout 'i8mm'), for int8 x
    int8 products: activations are quantized per row, and the row scale
    times the column scale covers the whole K reduction.

    data: (K, N) int8 codes; scale: (N,) float32 column scales.  An
    expert stack has a leading axis on all three: (E, K, N) codes and (E,
    N) scales; ``select`` takes one expert's 2-D weight.
    """

    shape: tuple
    data: torch.Tensor
    scale: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.data.numel() + self.scale.numel() * 4

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale[..., None, :]).to(dtype)

    def select(self, i: int) -> "Int8MXUTensor":
        """Entry i of the leading axis (one expert of a stack), as views."""
        return Int8MXUTensor(tuple(self.shape[1:]), self.data[i],
                             self.scale[i])

    def to(self, device) -> "Int8MXUTensor":
        return Int8MXUTensor(self.shape, self.data.to(device),
                             self.scale.to(device))

    @classmethod
    def from_np(cls, t: dict, device="cuda") -> "Int8MXUTensor":
        """From a ``{"shape", "data", "scale"}`` dict of numpy arrays (the
        JAX package's Int8MXUTensor fields), on `device`."""
        device = resolve_device(device)
        return cls(tuple(int(s) for s in t["shape"]),
                   _numpy_to_torch(t["data"]).to(device),
                   _numpy_to_torch(t["scale"]).to(device))


def requantize_i8_colwise(qt) -> Int8MXUTensor:
    """Re-encode a weight (QuantizedTensor or dense (K, N) tensor) into the
    per-column int8 container.  Bytes equal to codec_jax's."""
    if isinstance(qt, QuantizedTensor):
        wd = dequantize(qt, torch.float32)
    else:
        wd = qt.float()
    amax = wd.abs().amax(dim=0)
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.round(wd / scale[None, :]).clamp(-127, 127)  # half to even
    return Int8MXUTensor(tuple(wd.shape), q.to(torch.int8), scale)


def int8_rowwise_activations(x: torch.Tensor):
    """Per-row symmetric int8 quantization: (int8 codes, (…, 1) float32
    row scales), rounding half to even as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _device_memory_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).total_memory


def resolve_auto_layout(spec, weight_format, device="cuda") -> str:
    """The device layout for device_layout in ('', 'auto').

    Capacity rule: sub-byte wire formats take the int8 container ('i8mm')
    when it fits in 75% of the card's memory (the rest is left to the KV
    cache and activations); else 4-bit single-plane unsigned formats take
    'i4' and the rest keep the wire planes ('packed').  Byte formats, dense
    and whole-tensor types keep ''.  Explicit layouts pass through.  On the
    CPU nothing is resolved (''), as the JAX package resolves nothing off
    its accelerator."""
    if getattr(spec, "device_layout", "") not in ("", "auto"):
        return spec.device_layout
    dev = torch.device(device)
    if not weight_format or dev.type != "cuda":
        return ""
    if weight_format.upper() in GLOBAL_TYPES:
        return ""
    try:
        fmt = get_format(weight_format)
    except KeyError:
        return ""
    if not (fmt.pair_base11 or any(p.bits < 8 for p in fmt.planes)):
        return ""
    hp = spec.hyper_params
    e, d = hp.embd_dims, hp.head_dim
    hq, hk = hp.decoder_heads, hp.kv_heads
    f = hp.decoder_intermediate_size or 4 * e
    n_exp = max(hp.experts, 1)
    attn_params = hp.decoder_layers * (e * (hq + 2 * hk) * d + hq * d * e)
    ffn_params = hp.decoder_layers * n_exp * 3 * e * f
    # the embeddings stay dense bf16 in every layout; only the lm_head
    # takes the container
    emb_bytes = 2 * hp.vocab_size * e
    head_params = hp.vocab_size * e
    # 1 byte per weight + one f32 scale per column (~8.03 bits)
    i8mm_bytes = (attn_params + ffn_params + head_params) * 65 // 64 \
        + emb_bytes
    if i8mm_bytes <= 0.75 * _device_memory_bytes(dev):
        return "i8mm"
    return "i4" if _i4_format(fmt) else "packed"


# FFN leaves that take the q8c container under the 'mixed' layout
MIXED_CONTAINER_LEAVES = frozenset({"w1", "w2", "w3", "w1n3"})


def layout_for_leaf(layout: str, leaf: str) -> str:
    """Per-tensor device layout under a whole-model decision: 'mixed' is
    q8c for the FFN leaves and the wire planes elsewhere; every other
    layout is uniform."""
    if layout != "mixed":
        return layout
    return "q8c" if leaf in MIXED_CONTAINER_LEAVES else "packed"


def requantize_q8_container(qt: QuantizedTensor) -> QuantizedTensor:
    """Device layout 'q8c' (codec_jax.requantize_q8_container): the tensor
    dequantized to float32 and quantized again as Q8_B32T2 (signed int8
    codes, an f16 scale per 32 rows, no base), one byte per weight read by
    kernel B1's Q8 case and B4's byte mode.  Bytes equal to the JAX
    codec's; a Q8_B32T2 tensor passes through unchanged."""
    if qt.format == "Q8_B32T2":
        return qt
    return quantize(dequantize(qt, torch.float32), "Q8_B32T2")
