"""Attention over the KV cache: decode (kernel B2), chunked prefill
(kernel B3) and decode over the paged pool (kernel B7).

Port of inferflow_tpu/kernels/attention.py (`decode_attention`,
`chunk_attention`).  On CUDA tensors the wrappers launch the hand-written
kernels of ``csrc/attention.cu`` or raise; on CPU tensors they run the plain
versions below, which ``chip_smoke.py`` also holds the kernels against on
the card.  They read the cache in its logical layout (runtime/kv_cache.py,
runtime/paged_kv.py) and dequantize K/V in float32, as the Pallas kernels
do.  ``decode_attention`` dispatches on the cache type as the JAX one does:
a PagedKVCache takes B7.

Shapes: B2 and B3 take head_dim a multiple of 16 up to 256 and any number
of query heads per kv head (B2 is instantiated for head dims up to 128 and
up to 256, B3 up to 64, 128 and 256; the head dims above 128 have their own
launch count: ``decode_attention`` / ``decode_attention_d256`` and so on);
B7 takes head_dim 32, 64, 128 or 256.  That covers every head shape the JAX kernels take
(`decode_attention_supported`) and more, such as 48 or 80, where the JAX
decoder falls back to XLA's ``mha``.  On the card a shape outside
``attention_kernel_supported`` raises NotImplementedError; it never runs
the plain version there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime.kv_cache import KVCache
from ..runtime.paged_kv import PagedKVCache
from . import _build

DECODE_KERNEL = "decode_attention"
CHUNK_KERNEL = "chunk_attention"
PAGED_KERNEL = "paged_decode_attention"
NEG_INF = -1e30
_MAX_D = 256
_PAGED_D = (32, 64, 128, 256)  # head dims of the paged kernel (csrc)
_MAX_SPLIT = 16  # CTAs per (slot, kv head) walk
_MAX_ROWS = 16  # query rows per B2 CTA (csrc kMaxRows)
_SPLIT_ROWS = 256  # least keys per CTA of B2's split walk (csrc kSplitRows)
_CHUNK_ROWS = 64  # query rows per B3 CTA (csrc kChunkRows)
_CHUNK_SPLIT_TILES = 8  # least key tiles per CTA of B3's split walk

# B3's launch count name -> the nsplit its last launch passed to the kernel
# (the most CTAs a row block's walk was split over; a row block with fewer
# key tiles uses fewer)
last_chunk_split: dict = {}


def attention_kernel_supported(cache) -> bool:
    """Whether the card's attention kernels take this cache's head shape:
    B7 (a PagedKVCache) head_dim in _PAGED_D; B2/B3 head_dim a multiple of
    16 up to _MAX_D, quantized in blocks of a multiple of 16 values."""
    d = cache.head_dim
    if isinstance(cache, PagedKVCache):
        return d in _PAGED_D and cache.page_tokens % 32 == 0
    return (d <= _MAX_D and d % 16 == 0
            and not (cache.quantized and cache.block % 16))


def kernel_name(base: str, d: int) -> str:
    """The launch count of a kernel's instantiation for head_dim d: the
    head dims above 128 run their own (``<base>_d256``)."""
    return f"{base}_d256" if d > 128 else base


def chunk_tile(d: int) -> int:
    """Keys per tile of B3's walk at head_dim d (csrc chunk_tile)."""
    return 32 if d > 128 else 64


def chunk_split(c: int, hq: int, h: int, d: int, start: int,
                resident: int) -> int:
    """CTAs over which B3 splits each row block's key walk, given the
    CTAs of B3 the card holds at once (`resident`: SMs x chunk_ctas_per_sm):
    as many as keep every CTA of the (H, ceil(C*g / 64)) grid's splits
    resident together, at most _MAX_SPLIT, and no fewer than
    _CHUNK_SPLIT_TILES key tiles each (the longest walk's); 1 when a split
    of two would not fit (a second wave costs more than the balance
    gains)."""
    ctas = h * -(-c * (hq // h) // _CHUNK_ROWS)
    tiles = -(-(start + c) // chunk_tile(d))
    return max(1, min(_MAX_SPLIT, resident // ctas,
                      tiles // _CHUNK_SPLIT_TILES))


def _scale(d: int, kq_scale: float) -> float:
    return (1.0 / (d ** 0.5)) * kq_scale


def _masked_softmax_attend(q, k, v, mask, scale):
    """q (..., R, D), k/v (..., S, D) float32, mask (..., R, S) bool."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _decode_attend(q, k, v, lengths, kq_scale):
    """q (B, Hq, D), k/v (B, S, H, D) float32 -> (B, Hq, D) in q's dtype;
    slot b sees keys [0, lengths[b]); a slot with no keys gets zeros, as
    the kernels' empty walks give."""
    bsz, hq, d = q.shape
    h = k.shape[2]
    g = hq // h
    k = k.permute(0, 2, 1, 3)  # (B, H, S, D)
    v = v.permute(0, 2, 1, 3)
    qf = q.float().reshape(bsz, h, g, d)
    lengths = lengths.to(q.device)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    out = _masked_softmax_attend(qf, k, v, mask, _scale(d, kq_scale))
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(bsz, hq, d).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, cache: KVCache, layer: int,
                           lengths: torch.Tensor, kq_scale: float = 1.0):
    """q (B, Hq, D) -> (B, Hq, D) in q's dtype; slot b sees keys
    [0, lengths[b])."""
    k, v = cache.read_layer(layer, torch.float32)  # (B, S, H, D)
    return _decode_attend(q, k, v, lengths, kq_scale)


def paged_decode_attention_plain(q: torch.Tensor, cache: PagedKVCache,
                                 layer: int, lengths: torch.Tensor,
                                 kq_scale: float = 1.0):
    """B7's plain version: the rows of the pages that cover the longest
    slot, gathered through the page table (read_layer), then the masked
    softmax of decode_attention_plain.  q (B, Hq, D) -> (B, Hq, D)."""
    longest = int(lengths.max()) if lengths.numel() else 0
    n_pages = min(max(-(-longest // cache.page_tokens), 1),
                  cache.max_pages_per_slot)
    k, v = cache.read_layer(layer, torch.float32, n_pages)
    return _decode_attend(q, k, v, lengths, kq_scale)


def chunk_attention_plain(q: torch.Tensor, cache: KVCache, layer: int,
                          slot: int, start: int, kq_scale: float = 1.0):
    """q (C, Hq, D) at positions start..start+C-1 of `slot` -> (C, Hq, D);
    row c sees keys [0, start + c]."""
    c, hq, d = q.shape
    h = cache.kv_heads
    g = hq // h
    n_keys = start + c
    k, v = cache.read_layer(layer, torch.float32)
    k = k[slot, :n_keys].permute(1, 0, 2)  # (H, n_keys, D)
    v = v[slot, :n_keys].permute(1, 0, 2)
    qf = q.float().reshape(c, h, g, d).permute(1, 0, 2, 3).reshape(h, c * g, d)
    row_pos = start + torch.arange(c * g, device=q.device) // g
    mask = torch.arange(n_keys, device=q.device)[None, :] <= row_pos[:, None]
    out = _masked_softmax_attend(qf, k, v, mask[None], _scale(d, kq_scale))
    return out.reshape(h, c, g, d).permute(1, 0, 2, 3).reshape(c, hq, d).to(
        q.dtype)


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_ift_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ift_decode_attention.argtypes = [vp] * 9 + [i] * 9 + [f, vp]
        lib.ift_decode_attention.restype = ctypes.c_int
        lib.ift_chunk_attention.argtypes = [vp] * 8 + [i] * 12 + [f, vp]
        lib.ift_chunk_attention.restype = ctypes.c_int
        lib.ift_chunk_ctas_per_sm.argtypes = [i] * 3 + [vp]
        lib.ift_chunk_ctas_per_sm.restype = ctypes.c_int
        lib.ift_paged_decode_attention.argtypes = \
            [vp] * 10 + [i] * 10 + [f, vp]
        lib.ift_paged_decode_attention.restype = ctypes.c_int
        lib._ift_typed = True
    return lib


def _cache_operands(cache: KVCache):
    """Checked cache pointers: (k, k_scale, v, v_scale, quantized, blk)."""
    if not attention_kernel_supported(cache):
        raise NotImplementedError(
            f"the attention kernels take head_dim a multiple of 16 up to "
            f"{_MAX_D} (D={cache.head_dim}, block {cache.block})")
    shape = tuple(cache.k.shape)
    if cache.quantized:
        _build.check_operand(cache.k, "k", torch.int8, shape)
        _build.check_operand(cache.v, "v", torch.int8, shape)
        sshape = tuple(cache.k_scale.shape)
        _build.check_operand(cache.k_scale, "k_scale", torch.float16, sshape)
        _build.check_operand(cache.v_scale, "v_scale", torch.float16, sshape)
        return (_build.ptr(cache.k), _build.ptr(cache.k_scale),
                _build.ptr(cache.v), _build.ptr(cache.v_scale), 1,
                cache.block)
    _build.check_operand(cache.k, "k", torch.bfloat16, shape)
    _build.check_operand(cache.v, "v", torch.bfloat16, shape)
    null = ctypes.c_void_p(0)
    return (_build.ptr(cache.k), null, _build.ptr(cache.v), null, 0,
            cache.head_dim)


def decode_attention_cuda(q: torch.Tensor, cache: KVCache, layer: int,
                          lengths: torch.Tensor, kq_scale: float = 1.0):
    """Launch kernel B2: q (B, Hq, D) bf16 -> (B, Hq, D) bf16."""
    _build.require_hopper(q)
    num_layers, bsz, h, s, d = cache.k.shape
    hq = q.shape[1]
    if not 0 <= layer < num_layers:
        raise ValueError(f"layer {layer} out of range")
    _build.check_operand(q, "q", torch.bfloat16, (bsz, hq, d))
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    _build.check_operand(lengths, "lengths", torch.int32, (bsz,), align=4)
    k, ks, v, vs, quantized, blk = _cache_operands(cache)
    g = hq // h
    ctas = bsz * h * -(-g // _MAX_ROWS)
    # CTAs per walk: the kernel gives a slot of n rows min(nsplit,
    # ceil(n / _SPLIT_ROWS)) of them
    nsplit = max(1, min(_MAX_SPLIT, -(-s // _SPLIT_ROWS)))
    null = ctypes.c_void_p(0)
    part = counters = None
    if nsplit > 1:
        part = torch.empty(ctas * nsplit * min(g, _MAX_ROWS) * (d + 2),
                           dtype=torch.float32, device=q.device)
        counters = torch.zeros(ctas, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.ift_decode_attention(
        _build.ptr(q), k, ks, v, vs, _build.ptr(lengths),
        null if part is None else _build.ptr(part),
        null if counters is None else _build.ptr(counters), _build.ptr(out),
        int(layer), bsz, h, s, d, blk, g, nsplit, quantized,
        _scale(d, kq_scale), _build.stream_of(q))
    _build.check(lib, rc, DECODE_KERNEL)
    _build.launch_counts[kernel_name(DECODE_KERNEL, d)] += 1
    return out


@functools.lru_cache(maxsize=None)
def chunk_ctas_per_sm(device: int, d: int, blk: int, quantized: int) -> int:
    """CTAs of B3 one SM of card `device` holds at once for head_dim d
    (the CUDA runtime's occupancy of the instantiation and shared memory
    that ift_chunk_attention launches)."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.ift_chunk_ctas_per_sm(d, blk, quantized, ctypes.byref(n))
    _build.check(lib, rc, CHUNK_KERNEL)
    return n.value


def chunk_attention_cuda(q: torch.Tensor, cache: KVCache, layer: int,
                         slot: int, start: int, kq_scale: float = 1.0,
                         nsplit: int | None = None):
    """Launch kernel B3: q (C, Hq, D) bf16 -> (C, Hq, D) bf16; each row
    block's key walk split over `nsplit` CTAs (None: chunk_split's)."""
    _build.require_hopper(q)
    num_layers, bsz, h, s, d = cache.k.shape
    c, hq, _ = q.shape
    if not (0 <= layer < num_layers and 0 <= slot < bsz
            and 0 <= start and start + c <= s):
        raise ValueError(f"chunk (layer {layer}, slot {slot}, rows "
                         f"[{start}, {start + c})) outside the cache")
    _build.check_operand(q, "q", torch.bfloat16, (c, hq, d))
    k, ks, v, vs, quantized, blk = _cache_operands(cache)
    if nsplit is None:
        dev = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = chunk_split(c, hq, h, d, start, sms * chunk_ctas_per_sm(
            dev, d, blk, quantized))
    null = ctypes.c_void_p(0)
    part = counters = None
    if nsplit > 1:
        blocks = h * -(-c * (hq // h) // _CHUNK_ROWS)
        part = torch.empty(blocks * nsplit * _CHUNK_ROWS * (d + 4),
                           dtype=torch.float32, device=q.device)
        counters = torch.zeros(blocks, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.ift_chunk_attention(
        _build.ptr(q), k, ks, v, vs,
        null if part is None else _build.ptr(part),
        null if counters is None else _build.ptr(counters), _build.ptr(out),
        int(layer), bsz, h, s, d, blk, hq // h, int(slot), int(start), c,
        nsplit, quantized, _scale(d, kq_scale), _build.stream_of(q))
    _build.check(lib, rc, CHUNK_KERNEL)
    _build.launch_counts[kernel_name(CHUNK_KERNEL, d)] += 1
    last_chunk_split[kernel_name(CHUNK_KERNEL, d)] = nsplit
    return out


def paged_decode_attention_cuda(q: torch.Tensor, cache: PagedKVCache,
                                layer: int, lengths: torch.Tensor,
                                kq_scale: float = 1.0):
    """Launch kernel B7: q (B, Hq, D) bf16 -> (B, Hq, D) bf16."""
    _build.require_hopper(q)
    num_layers, pages, h, pt, d = cache.k.shape
    bsz, hq, _ = q.shape
    g = hq // h
    if not attention_kernel_supported(cache) or g * h != hq:
        raise NotImplementedError(
            f"the paged attention kernel takes head_dim in {_PAGED_D} and "
            f"pages of a multiple of 32 rows (D={d}, Hq={hq}, H={h}, "
            f"PT={pt})")
    if not 0 <= layer < num_layers:
        raise ValueError(f"layer {layer} out of range")
    maxp = cache.max_pages_per_slot
    _build.check_operand(q, "q", torch.bfloat16, (bsz, hq, d))
    _build.check_operand(cache.page_table, "page_table", torch.int32,
                         (bsz, maxp), align=4)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    _build.check_operand(lengths, "lengths", torch.int32, (bsz,), align=4)
    shape = tuple(cache.k.shape)
    null = ctypes.c_void_p(0)
    ks = vs = null
    if cache.quantized:
        _build.check_operand(cache.k, "k", torch.int8, shape)
        _build.check_operand(cache.v, "v", torch.int8, shape)
        sshape = shape[:-1] + (d // 32,)
        _build.check_operand(cache.k_scale, "k_scale", torch.float16, sshape,
                             align=4)
        _build.check_operand(cache.v_scale, "v_scale", torch.float16, sshape,
                             align=4)
        ks, vs = _build.ptr(cache.k_scale), _build.ptr(cache.v_scale)
    else:
        _build.check_operand(cache.k, "k", torch.bfloat16, shape)
        _build.check_operand(cache.v, "v", torch.bfloat16, shape)
    nsplit = min(_MAX_SPLIT, maxp)
    rows = 16 if d <= 128 else 8  # query rows per CTA (csrc)
    groups = -(-g // rows)
    part = torch.empty(bsz * h * groups * nsplit * rows * (d + 2),
                       dtype=torch.float32, device=q.device)
    counters = torch.zeros(bsz * h * groups, dtype=torch.int32,
                           device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.ift_paged_decode_attention(
        _build.ptr(q), _build.ptr(cache.k), ks, _build.ptr(cache.v), vs,
        _build.ptr(cache.page_table), _build.ptr(lengths), _build.ptr(part),
        _build.ptr(counters), _build.ptr(out), int(layer), bsz, h, pages,
        pt, maxp, d, g, nsplit, int(cache.quantized),
        _scale(d, kq_scale), _build.stream_of(q))
    _build.check(lib, rc, PAGED_KERNEL)
    _build.launch_counts[kernel_name(PAGED_KERNEL, d)] += 1
    return out


def decode_attention(q: torch.Tensor, cache, layer: int,
                     lengths: torch.Tensor, *, kq_scale: float = 1.0):
    """Decode attention for one layer (inferflow_tpu signature): kernel B2
    over a KVCache, kernel B7 over a PagedKVCache.

    q: (B, 1, Hq, D); lengths: (B,) valid KV rows per slot INCLUDING the
    row just appended.  Returns ((B, 1, Hq, D), cache)."""
    paged = isinstance(cache, PagedKVCache)
    if q.device.type == "cpu":
        plain = paged_decode_attention_plain if paged \
            else decode_attention_plain
        out = plain(q[:, 0], cache, layer, lengths, kq_scale)
    elif q.device.type == "cuda":
        launch = paged_decode_attention_cuda if paged \
            else decode_attention_cuda
        out = launch(q[:, 0].contiguous(), cache, layer, lengths, kq_scale)
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return out[:, None], cache


def chunk_attention(q: torch.Tensor, cache: KVCache, layer: int, slot: int,
                    start: int, *, kq_scale: float = 1.0):
    """Chunk attention for one slot (inferflow_tpu signature): q
    (1, C, Hq, D) attends to cache rows [0, start + C) of `slot`, causal
    per row; the chunk's K/V must already be in the cache.  Returns
    ((1, C, Hq, D), cache)."""
    if q.device.type == "cpu":
        out = chunk_attention_plain(q[0], cache, layer, slot, start,
                                    kq_scale)
    elif q.device.type == "cuda":
        out = chunk_attention_cuda(q[0].contiguous(), cache, layer, slot,
                                   start, kq_scale)
    else:
        raise ValueError(f"chunk_attention: unsupported device {q.device}")
    return out[None], cache
