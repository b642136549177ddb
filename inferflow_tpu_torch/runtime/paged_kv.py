"""Paged KV cache: a page pool plus per-slot page tables.

Port of inferflow_tpu/runtime/paged_kv.py.  The dense KVCache reserves
max_context rows per slot; here K/V live in a POOL of fixed-size pages and
each slot owns a list of page ids, so device memory scales with the tokens
in flight, not with slots x max_context.  One page id covers that page's
rows in every layer.

Page size: PT = PAGE_S2 * kv_pack_for(D) tokens, the JAX package's (128
tokens at D = 128, 256 at D = 64), so the pool size, the pages a query
reserves and the engine's admission decisions equal the JAX engine's.

Storage keeps the port's logical layout, one page at a time:

    k/v:      (L, P, H, PT, D)        int8 codes, or the dense dtype
    scales:   (L, P, H, PT, D/blk)    f16
    page_table (B, MAXP) int32 on the device, and a host copy of it
    length    (B,) int32

so a page of one (layer, kv head) is one contiguous (PT, D) block that the
kernels read as 16-byte rows.  Page 0 is the sentinel: the engine never
hands it out, unassigned table entries point at it, and the throw-away rows
of inactive slots land there.

Writes update the buffers in place and return the cache, as KVCache does.
The host copy of the table serves the engine's bookkeeping: a row is
mirrored to the device only when it changes, so no step reads the table
back from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .kv_cache import KVCache, kv_block_for
from ..quant.codec_torch import dequantize_q8_sym, quantize_q8_sym

PAGE_S2 = 128  # the JAX package's storage rows per page (one lane tile)


def kv_pack_for(head_dim: int) -> int:
    """The JAX package's sequence pack factor (pf = 128/D for D < 128);
    here it only sets the page size in tokens."""
    if head_dim < 128 and 128 % head_dim == 0:
        return 128 // head_dim
    return 1


def page_tokens_for(head_dim: int) -> int:
    return PAGE_S2 * kv_pack_for(head_dim)


@dataclasses.dataclass
class PagedKVCache:
    """The decode-side cache protocol of KVCache (update_layer /
    read_layer / length / with_length / quantized / head_dim) over a page
    pool."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor  # (B, MAXP) int32 page ids (unassigned = 0)
    length: torch.Tensor      # (B,) int32 valid rows per slot
    head_dim: int = 0
    page_table_host: Optional[np.ndarray] = None  # host copy of page_table

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def page_tokens(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_len(self) -> int:
        return self.max_pages_per_slot * self.page_tokens

    @property
    def block(self) -> int:
        return kv_block_for(self.head_dim)

    @classmethod
    def create(cls, layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, pool_tokens: int = 0, quantized: bool = True,
               dtype=torch.bfloat16, device="cuda") -> "PagedKVCache":
        """A pool of ceil(pool_tokens / PT) pages (batch * max_len tokens
        when pool_tokens <= 0) and a (batch, ceil(max_len / PT)) table."""
        device = resolve_device(device)
        pt = page_tokens_for(head_dim)
        maxp = -(-max_len // pt)
        if pool_tokens <= 0:
            pool_tokens = batch * max_len
        p = max(-(-pool_tokens // pt), 1)
        shape = (layers, p, kv_heads, pt, head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        table = torch.zeros((batch, maxp), dtype=torch.int32, device=device)
        host = np.zeros((batch, maxp), np.int32)
        if quantized:
            sshape = shape[:-1] + (head_dim // kv_block_for(head_dim),)
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       torch.zeros(sshape, dtype=torch.float16, device=device),
                       table, length, head_dim, host)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), None, None,
                   table, length, head_dim, host)

    def with_length(self, length: torch.Tensor) -> "PagedKVCache":
        self.length = length.to(device=self.k.device, dtype=torch.int32)
        return self

    def with_page_row(self, slot: int, pids) -> "PagedKVCache":
        """Set slot's table row to `pids` followed by zeros (page 0)."""
        row = np.zeros((self.max_pages_per_slot,), np.int32)
        pids = np.asarray(pids, np.int32).reshape(-1)
        row[:len(pids)] = pids
        self.page_table_host[slot] = row
        self.page_table[slot] = torch.from_numpy(row).to(self.k.device)
        return self

    def _encode(self, new: torch.Tensor):
        """(…, D) rows -> (codes, scales) or (rows in storage dtype, None)."""
        if self.quantized:
            return quantize_q8_sym(new, self.block)
        return new.to(self.k.dtype), None

    def _row_address(self, start: torch.Tensor):
        """Per-slot (page id, row in page) of logical row `start` (B,),
        clamped to the table as the dense cache clamps to S - 1."""
        pos = start.to(device=self.k.device, dtype=torch.long).clamp(
            0, self.max_len - 1)
        slots = torch.arange(pos.shape[0], device=self.k.device)
        pid = self.page_table[slots, pos // self.page_tokens].long()
        return pid, pos % self.page_tokens

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, start: torch.Tensor
                     ) -> "PagedKVCache":
        """Append ONE (B, 1, H, D) row per slot at logical row start (B,):
        page page_table[b, start // PT], row start % PT (the engine has
        reserved the page; inactive slots write the page-0 sentinel)."""
        if k_new.shape[1] != 1:
            raise ValueError("paged decode append is one row per step")
        pid, off = self._row_address(start)
        for arr, sarr, new in ((self.k, self.k_scale, k_new),
                               (self.v, self.v_scale, v_new)):
            codes, scales = self._encode(new[:, 0])  # (B, H, D)
            arr[layer, pid, :, off, :] = codes
            if scales is not None:
                sarr[layer, pid, :, off, :] = scales
        return self

    def _gather(self, arr: torch.Tensor, layer: int, n_pages: int):
        """(B, H, n_pages * PT, X) rows of `layer` through the table."""
        table = self.page_table[:, :n_pages].long()
        pages = arr[layer][table]  # (B, n, H, PT, X)
        b, n, h, pt, x = pages.shape
        return pages.permute(0, 2, 1, 3, 4).reshape(b, h, n * pt, x)

    def read_layer(self, layer: int, dtype=torch.bfloat16,
                   n_pages: Optional[int] = None):
        """(B, S, H, D) logical K/V of a layer, S = n_pages * PT (all MAXP
        pages by default); rows past a slot's length are whatever their
        page holds: callers mask by length."""
        n = self.max_pages_per_slot if n_pages is None else n_pages
        if self.quantized:
            k = dequantize_q8_sym(self._gather(self.k, layer, n),
                                  self._gather(self.k_scale, layer, n),
                                  self.block, dtype)
            v = dequantize_q8_sym(self._gather(self.v, layer, n),
                                  self._gather(self.v_scale, layer, n),
                                  self.block, dtype)
        else:
            k = self._gather(self.k, layer, n).to(dtype)
            v = self._gather(self.v, layer, n).to(dtype)
        return k.transpose(1, 2), v.transpose(1, 2)


def append_rows_all_layers_paged(pc: PagedKVCache, k_new: torch.Tensor,
                                 v_new: torch.Tensor,
                                 start: torch.Tensor) -> PagedKVCache:
    """Paged analog of kv_cache.append_rows_all_layers: ONE decode row per
    slot for ALL layers, k_new/v_new (L, B, H, D), at logical row start
    (B,) of each slot, through the page table."""
    pid, off = pc._row_address(start)
    for arr, sarr, new in ((pc.k, pc.k_scale, k_new),
                           (pc.v, pc.v_scale, v_new)):
        codes, scales = pc._encode(new)
        # advanced indices (pid, off) around a slice: (B, L, H, D)
        arr[:, pid, :, off, :] = codes.transpose(0, 1)
        if scales is not None:
            sarr[:, pid, :, off, :] = scales.transpose(0, 1)
    return pc


def scatter_prefill_pages(pc: PagedKVCache, tmp: KVCache, pids, length: int,
                          slot: int) -> PagedKVCache:
    """Copy a (L, 1, H, T, D) dense prefill cache into the pool pages
    `pids` (rows [j*PT, (j+1)*PT) into pids[j]; a page the prefill covers
    only in part is zero-filled past it) and set the slot's length."""
    n = len(pids)
    rows = n * pc.page_tokens
    pid = torch.as_tensor(np.asarray(pids, np.int64), device=pc.k.device)
    for dst, src in ((pc.k, tmp.k), (pc.v, tmp.v),
                     (pc.k_scale, tmp.k_scale), (pc.v_scale, tmp.v_scale)):
        if dst is None:
            continue
        part = src[:, 0, :, :rows]  # (L, H, take, X)
        if part.shape[2] < rows:
            part = torch.nn.functional.pad(
                part, (0, 0, 0, rows - part.shape[2]))
        l, h, _, x = part.shape
        dst[:, pid] = part.reshape(l, h, n, pc.page_tokens, x).permute(
            0, 2, 1, 3, 4).to(dst.dtype)
    pc.length[slot] = length
    return pc
