"""Named architecture configs and a synthetic model builder (port of
inferflow_tpu/models/zoo.py).

Weights are drawn from a seeded ``torch.Generator`` on the target device
and quantized there (quant/codec_torch.py), layer by layer, so a full-size
model needs neither JAX nor a host round trip.  The draws differ from the
JAX builder's (another generator); tests that compare the two packages
move the JAX package's weights over with ``weights.params_from_numpy``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..quant.codec_torch import (layout_for_leaf, quantize, repack_i4,
                                 requantize_i8_colwise,
                                 requantize_q8_container, resolve_auto_layout)
from ..quant.formats import get_format
from .decoder import (DEVICE_LAYOUTS, check_supported, fuse_layer_weights,
                      stack_moe_experts)
from .spec import HyperParams, ModelSpec

CONFIGS = {
    # name: (layers, embd, heads, kv_heads, intermediate, vocab)
    "test-tiny": dict(layers=2, embd=64, heads=4, kv_heads=4, inter=128,
                      vocab=256),
    "stories15m": dict(layers=6, embd=288, heads=6, kv_heads=6, inter=768,
                       vocab=32000),
    "tinyllama-1.1b": dict(layers=22, embd=2048, heads=32, kv_heads=4,
                           inter=5632, vocab=32000),
    "llama2-7b": dict(layers=32, embd=4096, heads=32, kv_heads=32,
                      inter=11008, vocab=32000),
    "llama2-13b": dict(layers=40, embd=5120, heads=40, kv_heads=40,
                       inter=13824, vocab=32000),
    "mixtral-8x7b": dict(layers=32, embd=4096, heads=32, kv_heads=8,
                         inter=14336, vocab=32000, experts=8, moe_top_k=2),
    "test-moe": dict(layers=2, embd=64, heads=4, kv_heads=4, inter=128,
                     vocab=256, experts=4, moe_top_k=2),
    "mixtral-scaled": dict(layers=4, embd=4096, heads=32, kv_heads=8,
                           inter=14336, vocab=32000, experts=8,
                           moe_top_k=2),
    "test-llama": dict(layers=3, embd=256, heads=8, kv_heads=2, inter=512,
                       vocab=512),
}


def make_spec(name: str, **overrides) -> ModelSpec:
    cfg = dict(CONFIGS[name])
    cfg.update({k: overrides.pop(k) for k in list(overrides)
                if k in ("layers", "embd", "heads", "kv_heads", "inter",
                         "vocab", "experts", "moe_top_k")})
    hp = HyperParams(vocab_size=cfg["vocab"], embd_dims=cfg["embd"],
                     decoder_layers=cfg["layers"], decoder_heads=cfg["heads"],
                     decoder_kv_heads=cfg["kv_heads"], hidden_dim=cfg["embd"],
                     decoder_intermediate_size=cfg["inter"],
                     experts=cfg.get("experts", 0),
                     moe_top_k=cfg.get("moe_top_k", 0))
    kw = dict(norm_alg="rms", activation_fn="silu", pos_embedding_alg="rope",
              qk_column_order=2)
    kw.update(overrides)
    return ModelSpec(sid=name, hyper_params=hp, **kw)


def _maybe_quant(w: torch.Tensor, weight_format: Optional[str],
                 device_layout: str = "", leaf: str = ""):
    if weight_format in (None, "F16", "BF16", "F32"):
        return w.to(torch.bfloat16)
    if w.shape[0] % get_format(weight_format).block:
        return w.to(torch.bfloat16)  # K not a block multiple: stays dense
    qt = quantize(w, weight_format)
    layout = layout_for_leaf(device_layout, leaf)
    if layout == "i8mm":
        return requantize_i8_colwise(qt)
    # no K padding: the JAX zoo pads K to its TPU tile unit first; every
    # consumer here takes a stored K >= the logical K either way
    if layout == "i4":
        return repack_i4(qt)
    if layout == "q8c":
        return requantize_q8_container(qt)
    return qt  # Q3H comes out of quantize as pair8


def make_synthetic_params(spec: ModelSpec,
                          weight_format: Optional[str] = None, seed: int = 0,
                          device="cuda", device_layout: str = "") -> dict:
    """Random params (normal, std 0.5/sqrt(K) for (K, N) weights, 0.02 for
    embeddings), generated and quantized on `device` layer by layer, with
    qkv and w1|w3 fused; sets spec.qkv_format = 1 for the fused qkv.

    device_layout '' or 'auto' resolves on `device` (resolve_auto_layout:
    'i8mm' on the card for every model that fits, nothing on the CPU); under
    'i8mm' every quantized weight, the lm_head included, is requantized
    into the per-column int8 container, and under 'i4' every weight of a
    4-bit single-plane format is re-stored as packed signed nibbles
    (repack_i4).  Under 'q8c' every quantized weight is re-encoded as
    Q8_B32T2 (requantize_q8_container), under 'mixed' only the FFN weights
    (w1, w2, w3; layout_for_leaf), the rest keeping the wire planes.  Under
    '' (on the CPU) and 'packed', Q3H weights are kept as the pair8 plane
    quantize emits (one byte per base-11 pair code), the layout kernel B6
    reads.

    A MoE spec (hp.experts > 0) gets per layer ``moe = {"pre_norm",
    "gate", "experts_stacked"}`` in place of ``ffn``: a dense bf16 gate
    (E, n_exp) and each expert's w1, w2 and w3 under the chosen layout,
    built one expert at a time (only one expert's float32 weights exist at
    once) and fused to w1n3, then stacked on a leading expert axis
    (decoder.stack_moe_experts)."""
    check_supported(spec)
    dev = resolve_device(device)
    if device_layout in ("", "auto") and weight_format:
        device_layout = resolve_auto_layout(spec, weight_format, dev)
    if device_layout not in DEVICE_LAYOUTS:
        raise NotImplementedError(
            f"device layout {device_layout!r} is not ported")
    hp = spec.hyper_params
    e, inter, vocab = hp.embd_dims, hp.decoder_intermediate_size, hp.vocab_size
    q_dim = hp.decoder_heads * hp.head_dim
    kv_dim = hp.kv_heads * hp.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(k, n, std=None):
        std = 0.5 / k ** 0.5 if std is None else std
        return torch.randn((k, n), generator=gen, device=dev,
                           dtype=torch.float32) * std

    def weight(k, n, leaf):
        return _maybe_quant(rand(k, n), weight_format, device_layout, leaf)

    def ffn_weights():
        return {"w1": weight(e, inter, "w1"), "w2": weight(inter, e, "w2"),
                "w3": weight(e, inter, "w3")}

    def norm():
        return torch.ones(e, dtype=torch.bfloat16, device=dev)

    layers = []
    for _ in range(hp.decoder_layers):
        layer = {"attn": {"pre_norm": norm(),
                          "wq": weight(e, q_dim, "wq"),
                          "wk": weight(e, kv_dim, "wk"),
                          "wv": weight(e, kv_dim, "wv"),
                          "wo": weight(q_dim, e, "wo")}}
        if hp.experts:
            gate = rand(e, hp.experts).to(torch.bfloat16)
            experts = [fuse_layer_weights([{"ffn": ffn_weights()}])[0]["ffn"]
                       for _ in range(hp.experts)]
            layer["moe"] = {"pre_norm": norm(), "gate": gate,
                            "experts": experts}
            stack_moe_experts([layer])
            del experts
        else:
            layer["ffn"] = dict(ffn_weights(), pre_norm=norm())
        layers.extend(fuse_layer_weights([layer]))
    if all("qkv" in lp["attn"] for lp in layers):
        spec.qkv_format = 1
    return {
        "dec_embeddings": rand(vocab, e, std=0.02).to(torch.bfloat16),
        "dec_output_norm": torch.ones(e, dtype=torch.bfloat16, device=dev),
        "lm_head": weight(e, vocab, "lm_head"),
        "layers": layers,
    }
