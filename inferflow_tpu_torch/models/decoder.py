"""Decoder-only transformer forward (port of inferflow_tpu/models/decoder.py,
the subset the serving path uses).

Params are plain dictionaries of tensors: ``dec_embeddings`` (V, E),
``dec_output_norm`` (E,), ``lm_head`` (E, V), and ``layers``, a list of
per-layer dicts ``{"attn": {"pre_norm", "qkv" | "wq"/"wk"/"wv", "wo"},
"ffn": {"pre_norm", "w1n3" | "w1"/"w3", "w2"}}``; a MoE layer holds
``"moe": {"pre_norm", "gate" (E, n_exp) dense, "experts_stacked"}`` in
place of ``ffn``, its experts' FFN weights stacked on a leading expert
axis ((n_exp, K, N) leaves; ``stack_moe_experts``), or an ``experts``
list before stacking.  Weights are (K, N) tensors, QuantizedTensors or
Int8MXUTensors; activations are (B, T, E); q/k/v (B, T, H, D).

Attention routes by phase, as on the TPU:
  - prefill (T > 1, a fresh cache): append K/V, then ``mha`` over the
    dequantized cache rows (plain PyTorch);
  - decode (T == 1): append one row per slot, then ``decode_attention``
    over the whole stacked cache: kernel B2 for a KVCache, kernel B7 for a
    PagedKVCache (the row goes through the page table);
  - chunked prefill: append the chunk to its slot, then ``chunk_attention``
    (kernel B3) over rows [0, start + T).
Every quantized linear goes through ops/linear.py: ``quantized_matmul``
(kernel B1 for Q4 wire planes and the Q8 block formats, B5 for the i4
layout's packed nibbles, B6 for Q3H's pair8 plane), the i8mm product for
Int8MXUTensors.
A decode step (T == 1 with a cache) whose weights and cache the
whole-model fused step takes (``fused_step_preferred``: i8mm, i4 or Q8
block weights, the last under the q8c layout too, a Q8 cache, dense or
paged, B <= 8) runs ``fused_decode_step`` (kernel B4) for all layers at
once instead of the per-layer loop.
A MoE layer's FFN is ``moe_block`` (routed decode, or the dense one-hot
combine); the fused step takes routed MoE stacks in its mode (g).
Not ported: heterogeneous MoE stacks (dense first layers), ALiBi and
sinusoidal positions, parallel attention and the ring/tensor-parallel
paths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.attention import chunk_attention, decode_attention
from ..kernels.decode_step import fused_decode_step, fused_step_preferred
from ..ops.activations import activate, weak_scalar
from ..ops.attention import mha
from ..ops.linear import linear
from ..ops.norms import apply_norm, linear_norm
from ..ops.rope import rope
from ..quant.codec_torch import (Int8MXUTensor, QuantizedTensor,
                                 concat_quantized)
from ..runtime.kv_cache import KVCache
from .spec import ModelSpec


# the device layouts this package serves ('' and 'auto' resolve on the
# device: quant/codec_torch.resolve_auto_layout)
DEVICE_LAYOUTS = ("", "auto", "packed", "i8mm", "i4", "q8c", "mixed")


def check_supported(spec: ModelSpec) -> None:
    """Refuse the configurations this port does not serve yet."""
    hp = spec.hyper_params
    if hp.experts and (hp.moe_layer_start > 0 or hp.moe_layer_end not in (
            -1, hp.decoder_layers - 1, hp.decoder_layers)):
        raise NotImplementedError(
            "heterogeneous MoE stacks (dense layers outside "
            "moe_layer_start..moe_layer_end) are not ported")
    if spec.pos_embedding_alg not in ("rope", "empty", ""):
        raise NotImplementedError(
            f"position embedding {spec.pos_embedding_alg!r} is not ported")
    if spec.is_parallel_attn:
        raise NotImplementedError("parallel attention is not ported")
    if spec.w1n3_ranks > 1:
        raise NotImplementedError("rank-major w1n3 layouts are not ported")
    if spec.device_layout not in DEVICE_LAYOUTS:
        raise NotImplementedError(
            f"device layout {spec.device_layout!r} is not ported; this "
            "package serves the packed wire layout, i8mm, i4, q8c and "
            "mixed")


def _norm(spec: ModelSpec, x, params: dict, prefix: str, base: float = 0.0):
    w = params.get(prefix)
    b = params.get(f"{prefix}_b")
    if w is None and b is None:
        return x
    return apply_norm(spec.norm_alg, x, w, b, spec.norm_eps, base)


def _split_qkv(spec: ModelSpec, qkv, n_heads, n_kv_heads, head_dim):
    """qkv_format=1: [Q | K | V]; 0: per kv-head groups (g q heads, k, v)."""
    b, t, _ = qkv.shape
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim
    if spec.qkv_format == 1:
        return (qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim],
                qkv[..., q_dim + kv_dim:q_dim + 2 * kv_dim])
    group = n_heads // n_kv_heads
    x = qkv.reshape(b, t, n_kv_heads, (group + 2) * head_dim)
    q = x[..., :group * head_dim].reshape(b, t, q_dim)
    k = x[..., group * head_dim:(group + 1) * head_dim].reshape(b, t, kv_dim)
    v = x[..., (group + 1) * head_dim:].reshape(b, t, kv_dim)
    return q, k, v


def attention_block(spec: ModelSpec, lp: dict, x, positions,
                    layer_cache: Optional[dict]):
    """Self-attention sub-layer.  layer_cache: None, or
    {"cache", "layer", "start"} (prefill/decode; start (B,) = rows already
    in the cache), or {"cache", "layer", "slot", "chunk_start"} (a chunk of
    one slot).  Returns (output, layer_cache)."""
    hp = spec.hyper_params
    n_heads, n_kv, head_dim = hp.decoder_heads, hp.kv_heads, hp.head_dim
    b, t, _ = x.shape

    if "qkv" in lp:
        qkv = linear(x, lp["qkv"], lp.get("qkv_b"))
        q, k, v = _split_qkv(spec, qkv, n_heads, n_kv, head_dim)
    else:
        q = linear(x, lp["wq"], lp.get("wq_b"))
        k = linear(x, lp["wk"], lp.get("wk_b"))
        v = linear(x, lp["wv"], lp.get("wv_b"))
    q = q.reshape(b, t, n_heads, head_dim)
    k = k.reshape(b, t, n_kv, head_dim)
    v = v.reshape(b, t, n_kv, head_dim)

    if spec.pos_embedding_alg == "rope":
        rd = spec.effective_rope_dim()
        q = rope(q, positions, base=spec.rope_theta, order=spec.rope_order,
                 rope_dim=rd)
        k = rope(k, positions, base=spec.rope_theta, order=spec.rope_order,
                 rope_dim=rd)

    if layer_cache is None:
        out = mha(q, k, v, q_positions=positions, kq_scale=spec.kq_scale)
    elif "slot" in layer_cache:
        cache, layer = layer_cache["cache"], layer_cache["layer"]
        slot, start = layer_cache["slot"], layer_cache["chunk_start"]
        cache.update_layer_slot(layer, slot, k, v, start)
        out, _ = chunk_attention(q, cache, layer, slot, start,
                                 kq_scale=spec.kq_scale)
    else:
        cache, layer = layer_cache["cache"], layer_cache["layer"]
        start = layer_cache["start"]
        cache.update_layer(layer, k, v, start)
        if t == 1:
            out, _ = decode_attention(q, cache, layer, start + 1,
                                      kq_scale=spec.kq_scale)
        else:
            k_full, v_full = cache.read_layer(layer, x.dtype)
            out = mha(q, k_full, v_full, q_positions=positions,
                      kv_len=start + t, kq_scale=spec.kq_scale)

    out = linear(out.reshape(b, t, n_heads * head_dim), lp["wo"],
                 lp.get("wo_b"))
    if spec.attn_out_scale != 1.0:
        out = out * weak_scalar(spec.attn_out_scale, out)
    return out, layer_cache


def ffn_block(spec: ModelSpec, lp: dict, x):
    """Dense (GLU) FFN: w1 (+ w3 gate) -> activation -> w2."""
    if "w1n3" in lp:
        h = linear(x, lp["w1n3"], lp.get("w1n3_b"))
        inter = h.shape[-1] // 2
        a, g = h[..., :inter], h[..., inter:]
    else:
        a = linear(x, lp["w1"], lp.get("w1_b"))
        g = linear(x, lp["w3"], lp.get("w3_b")) if "w3" in lp else None
    out = linear(activate(spec.activation_fn, a, g), lp["w2"],
                 lp.get("w2_b"))
    if spec.ffn_out_scale != 1.0:
        out = out * weak_scalar(spec.ffn_out_scale, out)
    return out


def top_k_lowest(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, largest
    first, ties to the lower index (as jax.lax.top_k and the TPU kernel's
    argmax loop break them; torch.topk does not promise an order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_count(stacked: dict) -> int:
    """The expert axis of an experts_stacked dict."""
    w = stacked.get("w1n3", stacked.get("w1"))
    return int(w.shape[0])


def index_expert(stacked: dict, e: int) -> dict:
    """Expert e of an experts_stacked dict: its 2-D weights, as views
    (the counterpart of the JAX package's _index_layer on the expert
    axis)."""
    return {k: v.select(e) if isinstance(v, (QuantizedTensor, Int8MXUTensor))
            else v[e] for k, v in stacked.items()}


def moe_block(spec: ModelSpec, lp: dict, x):
    """Sparse-MoE FFN (the JAX package's moe_block): gate logits through
    linear (bf16 for a dense bf16 gate) to float32, softmax, top-k (ties
    to the lower expert), renormalised when moe_norm_top_k_prob.  Decode
    with stacked experts and B * top_k < n_exp runs only the chosen
    experts, slot by slot; otherwise every expert runs on every row and a
    one-hot combine weighs them.  Expert outputs add in float32 (plus the
    shared expert's), rounded to x's dtype once."""
    hp = spec.hyper_params
    top_k = hp.moe_top_k or 2
    stacked = lp.get("experts_stacked")
    n_exp = expert_count(stacked) if stacked is not None \
        else len(lp["experts"])
    logits = linear(x, lp["gate"], lp.get("gate_b")).float()
    top_vals, top_idx = top_k_lowest(torch.softmax(logits, dim=-1), top_k)
    if hp.moe_norm_top_k_prob:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    b, t, _ = x.shape
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if stacked is not None and t == 1 and b * top_k < n_exp:
        chosen = top_idx[:, 0].tolist()
        for bi in range(b):
            for j in range(top_k):
                y = ffn_block(spec, index_expert(stacked, chosen[bi][j]),
                              x[bi:bi + 1])
                out[bi] += y[0].float() * top_vals[bi, 0, j]
    else:
        combine = torch.einsum(
            "btke,btk->bte",
            F.one_hot(top_idx, n_exp).to(torch.float32), top_vals)
        for e in range(n_exp):
            elp = (index_expert(stacked, e) if stacked is not None
                   else lp["experts"][e])
            out = out + ffn_block(spec, elp, x).float() * combine[..., e:e + 1]
    if lp.get("shared"):
        out = out + ffn_block(spec, lp["shared"], x).float()
    return out.to(x.dtype)


def decoder_layer(spec: ModelSpec, lp: dict, x, positions,
                  layer_cache: Optional[dict]):
    """One pre-norm decoder layer (is_attn_post_as_residual honoured); a
    MoE layer runs moe_block in place of the dense FFN."""
    attn_p = lp["attn"]
    residual = x
    h = x
    if spec.use_self_attn_pre_norm:
        h = _norm(spec, x, attn_p, "pre_norm", spec.attn_pre_norm_base)
    attn_out, layer_cache = attention_block(spec, attn_p, h, positions,
                                            layer_cache)
    attn_out = _norm(spec, attn_out, attn_p, "post_norm")
    x = residual + attn_out if spec.is_attn_post_as_residual else attn_out
    if "moe" in lp:
        mp = lp["moe"]
        h = _norm(spec, x, mp, "pre_norm", spec.ffn_pre_norm_base)
        ffn_out = _norm(spec, moe_block(spec, mp, h), mp, "post_norm")
    else:
        fp = lp["ffn"]
        h = _norm(spec, x, fp, "pre_norm", spec.ffn_pre_norm_base)
        ffn_out = _norm(spec, ffn_block(spec, fp, h), fp, "post_norm")
    return x + ffn_out, layer_cache


def embed_tokens(spec: ModelSpec, params: dict, tokens, positions):
    """Token embedding rows (B, T, E) in bf16, plus the optional embedding
    scale and learned positions."""
    x = params["dec_embeddings"][tokens.to(params["dec_embeddings"].device)]
    x = x.to(torch.bfloat16)
    if spec.has_embedding_linear_norm:
        x = linear_norm(x, spec.embedding_linear_scale)
    if "dec_pos_embeddings" in params:
        off = spec.pos_embedding_offset
        x = x + params["dec_pos_embeddings"][positions + off].to(x.dtype)
    if "dec_input_norm" in params:
        x = apply_norm(spec.norm_alg, x, params.get("dec_input_norm"),
                       params.get("dec_input_norm_b"), spec.norm_eps)
    return x


def output_logits(spec: ModelSpec, params: dict, x):
    """Output norm + lm_head; float32 logits (B, T, V)."""
    x = apply_norm(spec.norm_alg, x, params.get("dec_output_norm"),
                   params.get("dec_output_norm_b"), spec.norm_eps,
                   spec.output_norm_base)
    head = params.get("lm_head")
    if head is None:
        head = params["dec_embeddings"].T  # tied weights
        if spec.normalize_lm_head:
            head = head / torch.linalg.norm(head.float(), dim=0,
                                            keepdim=True).to(head.dtype)
    logits = linear(x, head, params.get("lm_head_b"))
    if spec.out_scale != 1.0:
        logits = logits * weak_scalar(spec.out_scale, logits)
    return logits.float()


def decoder_forward(spec: ModelSpec, params: dict, tokens, positions,
                    cache: Optional[KVCache] = None
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full forward; tokens/positions (B, T).  With a cache, K/V rows are
    appended at cache.length and the length advances by T.  Returns
    (float32 logits (B, T, V), cache)."""
    x = embed_tokens(spec, params, tokens, positions)
    for i, lp in enumerate(params["layers"]):
        lc = None if cache is None else layer_cache_fused(cache, i)
        x, _ = decoder_layer(spec, lp, x, positions, lc)
    logits = output_logits(spec, params, x)
    if cache is not None:
        cache.with_length(cache.length + tokens.shape[1])
    return logits, cache


def layer_cache_fused(cache, layer: int) -> dict:
    """Layer view: the whole stacked cache (dense or paged) plus a layer
    index (the kernels index the stacked buffers; no per-layer slice is
    copied)."""
    return {"cache": cache, "layer": layer, "start": cache.length}


def decoder_layers_unrolled(spec: ModelSpec, layers: list, x, positions,
                            cache=None):
    """The layer loop of the decode step over a KVCache or PagedKVCache.
    A single-token step that the whole-model fused step takes
    (fused_step_preferred) runs it: kernel B4 on the card, its plain
    version on the CPU, the same route on both.  Everything else runs the
    per-layer loop (B7 for a paged cache).  Does NOT advance
    cache.length."""
    if cache is not None and x.shape[1] == 1 and fused_step_preferred(
            spec, layers, cache, x.shape[0]):
        return fused_decode_step(spec, layers, x, positions, cache)
    for i, lp in enumerate(layers):
        lc = None if cache is None else layer_cache_fused(cache, i)
        x, _ = decoder_layer(spec, lp, x, positions, lc)
    return x, cache


def decoder_layers_chunk(spec: ModelSpec, layers: list, x, positions,
                         cache: KVCache, slot: int, start: int):
    """Chunked-prefill loop: x is a (1, C) chunk of one slot; K/V append to
    the main cache at `start`, attention covers rows [0, start + C).  Does
    NOT advance cache.length (the engine commits it at the last chunk)."""
    for i, lp in enumerate(layers):
        lc = {"cache": cache, "layer": i, "slot": slot, "chunk_start": start}
        x, _ = decoder_layer(spec, lp, x, positions, lc)
    return x, cache


def _concat_weights(parts):
    """Concatenate weights along N: dense tensors, QuantizedTensors of one
    format and K, or Int8MXUTensors, 2-D or expert-stacked (every axis but
    N equal).  None when they cannot fuse."""
    first = parts[0]
    lead = tuple(first.shape[:-1])
    if isinstance(first, QuantizedTensor):
        if not all(isinstance(p, QuantizedTensor) and p.format == first.format
                   and tuple(p.shape[:-1]) == lead
                   and p.storage_k == first.storage_k for p in parts):
            return None
        return concat_quantized(parts)
    if isinstance(first, Int8MXUTensor):
        if not all(isinstance(p, Int8MXUTensor)
                   and tuple(p.shape[:-1]) == lead for p in parts):
            return None
        return Int8MXUTensor(
            lead + (sum(int(p.shape[-1]) for p in parts),),
            torch.cat([p.data for p in parts], dim=-1),
            torch.cat([p.scale for p in parts], dim=-1))
    if not all(isinstance(p, torch.Tensor) and tuple(p.shape[:-1]) == lead
               for p in parts):
        return None
    return torch.cat(parts, dim=-1)


def _fuse_ffn(blk: dict) -> dict:
    blk = dict(blk)
    if "w1" in blk and "w3" in blk and "w1_b" not in blk \
            and "w3_b" not in blk:
        fused = _concat_weights([blk["w1"], blk["w3"]])
        if fused is not None:
            blk.pop("w1"), blk.pop("w3")
            blk["w1n3"] = fused
    return blk


def fuse_layer_weights(layers: list) -> list:
    """Fuse wq|wk|wv -> qkv (qkv_format=1 order) and w1|w3 -> w1n3 per
    layer, MoE experts (listed or stacked on their (E, K, N) leaves) and
    the shared expert included; returns new layer dicts.  Callers set
    spec.qkv_format = 1 when the attention fusion applies."""
    out = []
    for layer in layers:
        layer = dict(layer)
        attn = dict(layer.get("attn", {}))
        if all(k in attn for k in ("wq", "wk", "wv")) and \
                not any(k + "_b" in attn for k in ("wq", "wk", "wv")):
            fused = _concat_weights([attn["wq"], attn["wk"], attn["wv"]])
            if fused is not None:
                for k in ("wq", "wk", "wv"):
                    attn.pop(k)
                attn["qkv"] = fused
        layer["attn"] = attn
        if "ffn" in layer:
            layer["ffn"] = _fuse_ffn(layer["ffn"])
        if "moe" in layer:
            moe = dict(layer["moe"])
            if "experts" in moe:
                moe["experts"] = [_fuse_ffn(e) for e in moe["experts"]]
            if "experts_stacked" in moe:
                moe["experts_stacked"] = _fuse_ffn(moe["experts_stacked"])
            if moe.get("shared"):
                moe["shared"] = _fuse_ffn(moe["shared"])
            layer["moe"] = moe
        out.append(layer)
    return out


def _stack(vals: list):
    """Stack one leaf of every expert along a new leading axis."""
    first = vals[0]
    if isinstance(first, QuantizedTensor):
        if any(not isinstance(v, QuantizedTensor) or v.format != first.format
               or set(v.planes) != set(first.planes)
               or (v.base is None) != (first.base is None) for v in vals):
            raise ValueError("experts of different formats")
        return QuantizedTensor(
            first.format, (len(vals),) + tuple(first.shape),
            {k: torch.stack([v.planes[k] for v in vals])
             for k in first.planes},
            torch.stack([v.scale for v in vals]),
            None if first.base is None
            else torch.stack([v.base for v in vals]))
    if isinstance(first, Int8MXUTensor):
        if any(not isinstance(v, Int8MXUTensor) for v in vals):
            raise ValueError("experts of different formats")
        return Int8MXUTensor((len(vals),) + tuple(first.shape),
                             torch.stack([v.data for v in vals]),
                             torch.stack([v.scale for v in vals]))
    return torch.stack(vals)


def stack_moe_experts(layers: list) -> list:
    """Replace each MoE layer's ``experts`` list by ``experts_stacked``,
    every leaf stacked on a leading expert axis (the JAX package's
    stack_moe_experts), in place; a list whose experts differ in keys,
    shapes or formats stays a list (the dense-combine path takes it).
    Each leaf's experts are copied into one tensor: build the experts
    stacked (models/zoo.py does) where a model's experts fill the card."""
    for layer in layers:
        moe = layer.get("moe")
        if not moe or not moe.get("experts"):
            continue
        experts = moe["experts"]
        keys = set(experts[0])
        if any(set(e) != keys for e in experts):
            continue
        try:
            stacked = {k: _stack([e[k] for e in experts]) for k in keys}
        except (ValueError, RuntimeError):
            continue  # heterogeneous formats or shapes: keep the list
        moe["experts_stacked"] = stacked
        del moe["experts"]
    return layers
