"""KV cache: static-shape per-slot cache with optional 8-bit quantization.

Port of inferflow_tpu/runtime/kv_cache.py.  The contract is the JAX one:
symmetric Q8 codes with one f16 scale per ``kv_block_for(D)`` elements of a
row, per-slot valid lengths, and the model-facing (B, S, H, D) /
(B, T, H, D) views of ``read_layer`` and the update methods.

Storage is the LOGICAL layout, heads outside the sequence axis:

    k/v:     (L, B, H, S, D)        int8 codes, or the dense dtype
    scales:  (L, B, H, S, D/blk)    f16

The TPU package packs 128/D sequence rows per 128-lane storage row; the
CUDA kernels read (S, D) rows directly, so nothing here is packed.  Writes
update the buffers in place (PyTorch tensors are mutable): the methods
return the cache itself so call sites read like the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..quant.codec_torch import dequantize_q8_sym, quantize_q8_sym

KV_BLOCK = 32


def kv_block_for(head_dim: int) -> int:
    """KV quant block: 32 (the reference's Q8_B32T2 capacity) or head_dim
    when heads are narrower than one block."""
    return KV_BLOCK if head_dim % KV_BLOCK == 0 else head_dim


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    length: torch.Tensor  # (B,) int32 valid rows per slot
    head_dim: int = 0

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def block(self) -> int:
        return kv_block_for(self.head_dim)

    @classmethod
    def create(cls, layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
               device="cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (layers, batch, kv_heads, max_len, head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if quantized:
            sshape = shape[:-1] + (head_dim // kv_block_for(head_dim),)
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       length, head_dim=head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), None, None,
                   length, head_dim=head_dim)

    def _encode(self, new: torch.Tensor):
        """(…, D) rows -> (codes, scales) or (rows in storage dtype, None)."""
        if self.quantized:
            return quantize_q8_sym(new, self.block)
        return new.to(self.k.dtype), None

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, start: torch.Tensor) -> "KVCache":
        """Write (B, T, H, D) rows at per-slot offsets start (B,).  Like the
        JAX dynamic_update_slice, an offset past S - T is clamped to it."""
        b, t = k_new.shape[:2]
        start = start.to(device=self.k.device, dtype=torch.long)
        start = start.clamp(0, self.max_len - t)
        pos = start[:, None] + torch.arange(t, device=self.k.device)[None]
        slots = torch.arange(b, device=self.k.device)[:, None]
        for arr, sarr, new in ((self.k, self.k_scale, k_new),
                               (self.v, self.v_scale, v_new)):
            codes, scales = self._encode(new)
            # advanced indices (slots, pos) around a slice: (B, T, H, D)
            arr[layer, slots, :, pos, :] = codes
            if scales is not None:
                sarr[layer, slots, :, pos, :] = scales
        return self

    def update_layer_slot(self, layer: int, slot: int, k_new: torch.Tensor,
                          v_new: torch.Tensor, start: int) -> "KVCache":
        """Write (1, T, H, D) rows for ONE slot at sequence offset `start`
        (chunked prefill)."""
        t = k_new.shape[1]
        start = min(max(int(start), 0), self.max_len - t)
        for arr, sarr, new in ((self.k, self.k_scale, k_new),
                               (self.v, self.v_scale, v_new)):
            codes, scales = self._encode(new[0].transpose(0, 1))  # (H, T, D)
            arr[layer, slot, :, start:start + t] = codes
            if scales is not None:
                sarr[layer, slot, :, start:start + t] = scales
        return self

    def read_layer(self, layer: int, dtype=torch.bfloat16):
        """Full (B, S, H, D) K/V of a layer, dequantized if needed."""
        if self.quantized:
            k = dequantize_q8_sym(self.k[layer], self.k_scale[layer],
                                  self.block, dtype)
            v = dequantize_q8_sym(self.v[layer], self.v_scale[layer],
                                  self.block, dtype)
        else:
            k = self.k[layer].to(dtype)
            v = self.v[layer].to(dtype)
        return k.transpose(1, 2), v.transpose(1, 2)

    def with_length(self, length: torch.Tensor) -> "KVCache":
        self.length = length.to(device=self.k.device, dtype=torch.int32)
        return self

    def scatter_slot(self, tmp: "KVCache", slot: int, length: int) -> None:
        """Copy a (L, 1, H, T, D) prefill cache into rows [0, T) of `slot`
        and set the slot's length."""
        t = tmp.max_len
        self.k[:, slot, :, :t] = tmp.k[:, 0]
        self.v[:, slot, :, :t] = tmp.v[:, 0]
        if self.quantized:
            self.k_scale[:, slot, :, :t] = tmp.k_scale[:, 0]
            self.v_scale[:, slot, :, :t] = tmp.v_scale[:, 0]
        self.length[slot] = length


def append_rows_all_layers(cache: KVCache, k_new: torch.Tensor,
                           v_new: torch.Tensor,
                           start: torch.Tensor) -> KVCache:
    """Write ONE row per slot for ALL layers: k_new/v_new (L, B, H, D)
    float rows (the fused decode step's per-layer K/V) at per-slot offsets
    start (B,), clamped to S - 1 as the JAX dynamic_update_slice clamps.
    Quantized caches take quantize_q8_sym codes and f16 scales."""
    b = k_new.shape[1]
    pos = start.to(device=cache.k.device, dtype=torch.long).clamp(
        0, cache.max_len - 1)
    slots = torch.arange(b, device=cache.k.device)
    for arr, sarr, new in ((cache.k, cache.k_scale, k_new),
                           (cache.v, cache.v_scale, v_new)):
        codes, scales = cache._encode(new)
        # advanced indices (slots, pos) around a slice: (B, L, H, D)
        arr[:, slots, :, pos, :] = codes.transpose(0, 1)
        if scales is not None:
            sarr[:, slots, :, pos, :] = scales.transpose(0, 1)
    return cache
