"""Attention at gemma-2b's head shape (head_dim 256, one kv head) and the
shape rule of the card's attention kernels, against the JAX package, on
the CPU.

The JAX kernels take head_dim 128 or 256 or a divisor of 128
(`decode_attention_supported`); for any other head dim its decoder falls
back to XLA's ``mha``.  The port's ``attention_kernel_supported`` (B2/B3:
a multiple of 16 up to 256; B7: 32, 64, 128 or 256) takes every head dim
of those that the JAX rule takes, and 48 and 80 besides; on the card a
shape outside it raises.  The model: test-llama's family cut to gemma-2b's attention shape
at a narrow width (2 layers, hidden 512, 2 query heads on 1 kv head, head
dim 256, Q4_B64T1 weights in their wire planes, a Q8 cache).  Neither
package's fused decode step takes head_dim 256, so decode runs the
per-layer loop at every batch size.

Tolerance: 5e-2 on logits of magnitude ~1 (tests/test_torch_decode_step.py's
engine gate): the port's attention dequantizes K/V in float32 where the
JAX CPU path rounds them to bf16 first, which moves later layers by bf16
steps; cache rows within two Q8 steps of the largest scale.
"""

import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.kernels import attention as jatt
from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu_torch.kernels import attention as tatt
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache as TPagedKVCache
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import _compare_caches, jax_params_to_numpy

LOGIT_TOL = 5e-2
GEMMA_HEAD = dict(layers=2, embd=512, heads=2, kv_heads=1, inter=1024,
                  vocab=256)


def _models(layout="packed", stacked=False):
    spec_j = jzoo.make_spec("test-llama", device_layout=layout, **GEMMA_HEAD)
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=5,
                                          stacked=stacked,
                                          device_layout=layout)
    spec_t = tzoo.make_spec("test-llama", device_layout=layout, **GEMMA_HEAD)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_t.hyper_params.head_dim == spec_j.hyper_params.head_dim == 256
    return spec_j, params_j, spec_t, params_t


def test_routing_rule_matches_jax():
    """attention_kernel_supported takes every head dim of 48, 64, 80, 128
    and 256 that the JAX rule takes (a cache whose sequence the JAX tile
    rule takes), and 48 and 80 besides; B7 takes its instantiated head
    dims only."""
    spec = jzoo.make_spec("test-llama")
    for d in (48, 64, 80, 128, 256):
        jc = JKVCache.create(1, 2, 512, 1, d, quantized=True)
        tc = TKVCache.create(1, 2, 512, 1, d, quantized=True, device="cpu")
        assert jatt.decode_attention_supported(jc, spec, 1) == (
            d not in (48, 80)), d
        assert tatt.attention_kernel_supported(tc), d
        paged = TPagedKVCache.create(1, 2, 512, 1, d, quantized=True,
                                     device="cpu")
        assert tatt.attention_kernel_supported(paged) == (
            d not in (48, 80)), d
    assert not tatt.attention_kernel_supported(
        TKVCache.create(1, 1, 64, 1, 72, quantized=True, device="cpu"))
    assert tatt.kernel_name("decode_attention", 256) == "decode_attention_d256"
    assert tatt.kernel_name("chunk_attention", 128) == "chunk_attention"


def test_decode_and_chunk_at_head_dim_256_match_jax():
    """One decode step at per-slot lengths (12 and 9) through the per-layer
    loop, then chunked prefill of a slot (two chunks of 8), at head dim
    256 against the JAX decoder (XLA's mha on the CPU)."""
    spec_j, params_j, spec_t, params_t = _models()
    hp = spec_t.hyper_params
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, hp.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jc = JKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads, hp.head_dim,
                         quantized=True)
    tc = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads, hp.head_dim,
                         quantized=True, device="cpu")
    _, jc = jdec.decoder_forward(spec_j, params_j, jnp.asarray(tokens),
                                 jnp.asarray(pos), jc)
    tdec.decoder_forward(spec_t, params_t, torch.from_numpy(tokens),
                         torch.from_numpy(pos), tc)
    lengths = np.asarray([12, 9], np.int32)
    jc = jc.with_length(jnp.asarray(lengths))
    tc.with_length(torch.from_numpy(lengths))
    step = rng.integers(0, hp.vocab_size, (2, 1)).astype(np.int32)
    spos = lengths[:, None]
    xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(step),
                           jnp.asarray(spos))
    xj, jc = jdec.decoder_layers_unrolled(spec_j, params_j["layers"], xj,
                                          jnp.asarray(spos), jc)
    xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(step),
                           torch.from_numpy(spos))
    xt, tc = tdec.decoder_layers_unrolled(spec_t, params_t["layers"], xt,
                                          torch.from_numpy(spos), tc)
    np.testing.assert_allclose(
        tdec.output_logits(spec_t, params_t, xt).numpy(),
        np.asarray(jdec.output_logits(spec_j, params_j, xj)),
        atol=LOGIT_TOL)
    _compare_caches(jc, tc)

    prompt = rng.integers(0, hp.vocab_size, (1, 16)).astype(np.int32)
    for start in (0, 8):
        chunk = prompt[:, start:start + 8]
        cpos = start + np.arange(8, dtype=np.int32)[None]
        xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(chunk),
                               jnp.asarray(cpos))
        xj, jc = jdec.decoder_layers_chunk(spec_j, params_j["layers"], xj,
                                           jnp.asarray(cpos), jc, 1, start)
        xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(chunk),
                               torch.from_numpy(cpos))
        xt, tc = tdec.decoder_layers_chunk(spec_t, params_t["layers"], xt,
                                           torch.from_numpy(cpos), tc, 1,
                                           start)
    np.testing.assert_allclose(
        tdec.output_logits(spec_t, params_t, xt).numpy(),
        np.asarray(jdec.output_logits(spec_j, params_j, xj)),
        atol=LOGIT_TOL)
    _compare_caches(jc, tc)


def test_fused_step_declines_head_dim_256(monkeypatch):
    """i8mm weights and a Q8 cache at B <= 8 would take the fused step;
    at head dim 256 both packages decline it (no raise), and the port's
    decode takes the per-layer loop at B = 1 and 8."""
    spec_j, params_j, spec_t, params_t = _models("i8mm", stacked=True)
    hp = spec_t.hyper_params
    jc = JKVCache.create(hp.decoder_layers, 2, 512, hp.kv_heads,
                         hp.head_dim, quantized=True)
    assert not jds.fused_step_supported(spec_j, params_j["layers"], jc, 2)
    monkeypatch.setattr(tdec, "fused_decode_step", lambda *a, **k: 1 / 0)
    for b in (1, 8):
        tc = TKVCache.create(hp.decoder_layers, b, 64, hp.kv_heads,
                             hp.head_dim, quantized=True, device="cpu")
        assert not tds.fused_step_supported(spec_t, params_t["layers"], tc, b)
        assert not tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
        x = torch.randn((b, 1, hp.embd_dims)).to(torch.bfloat16)
        y, _ = tdec.decoder_layers_unrolled(
            spec_t, params_t["layers"], x, torch.zeros((b, 1), dtype=torch.int32),
            tc)
        assert y.shape == x.shape and torch.isfinite(y.float()).all()
