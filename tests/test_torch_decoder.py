"""The port's decoder against the JAX decoder on test-tiny.

Both packages get the same weights: the JAX builder's Q4_B64T1 params (wire
planes, ``device_layout = "packed"`` pinned on both sides, since the JAX
package resolves no layout on the CPU) moved over with
``weights.params_from_numpy``.  The KV cache is Q8 on both sides.

Tolerances: the two packages round to bf16 at the same points (the bucketed
prefill gives bit-equal logits and caches here), but the port's decode and
chunk attention dequantize K/V in float32 where the JAX CPU path rounds
them to bf16 first, which moves later layers by bf16 steps.  Gates:
|diff| <= 2e-2 on logits of magnitude ~1; layer-0 cache rows (written
before any attention) equal; later rows within two Q8 steps of the largest
scale.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.quant.codec_jax import Int8MXUTensor as JI8
from inferflow_tpu.quant.codec_jax import QuantizedTensor as JQT
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.weights import params_from_numpy

LOGIT_TOL = 2e-2
TINY = dict(kv_heads=2, vocab=128)


def jax_params_to_numpy(tree):
    """JAX param tree -> numpy leaves, QuantizedTensor.to_np() dicts and
    Int8MXUTensor {"shape", "data", "scale"} dicts."""
    if isinstance(tree, JQT):
        return tree.to_np()
    if isinstance(tree, JI8):
        return {"shape": tuple(tree.shape), "data": np.asarray(tree.data),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: jax_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_params_to_numpy(v) for v in tree]
    return np.asarray(tree)


def tiny_models(seed=0, stacked=False):
    spec_j = jzoo.make_spec("test-tiny", device_layout="packed", **TINY)
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=seed,
                                          stacked=stacked,
                                          device_layout="packed")
    spec_t = tzoo.make_spec("test-tiny", device_layout="packed", **TINY)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    assert spec_j.qkv_format == spec_t.qkv_format == 1
    return spec_j, params_j, spec_t, params_t


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _compare_caches(jc, tc):
    for layer in range(tc.num_layers):
        for a, b in zip(tc.read_layer(layer, torch.float32),
                        jc.read_layer(layer, jnp.float32)):
            a, b = a.numpy(), np.asarray(b)
            if layer == 0:  # rows computed before any attention: exact
                np.testing.assert_array_equal(a, b)
            # two Q8 steps at the largest scale (amax/127): a block whose
            # max moves by a rounding moves its scale and every code with it
            step = np.abs(b).max() / 127.0
            assert np.abs(a - b).max() <= 2 * step + 1e-6


def test_params_from_numpy_stacked_matches_list():
    """A layer-stacked JAX tree splits into the same per-layer params."""
    _, _, _, listed = tiny_models(seed=1)
    _, _, _, stacked = tiny_models(seed=1, stacked=True)
    assert len(stacked["layers"]) == len(listed["layers"])
    for a, b in zip(stacked["layers"], listed["layers"]):
        qa, qb = a["attn"]["qkv"], b["attn"]["qkv"]
        assert qa.shape == qb.shape
        assert torch.equal(qa.planes["data"], qb.planes["data"])
        assert torch.equal(qa.scale, qb.scale)
        assert torch.equal(a["ffn"]["w2"].base, b["ffn"]["w2"].base)


def test_prefill_logits_and_cache_match_jax(models):
    spec_j, params_j, spec_t, params_t = models
    hp = spec_t.hyper_params
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, hp.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jc = JKVCache.create(hp.decoder_layers, 2, 32, hp.kv_heads, hp.head_dim,
                         quantized=True)
    tc = TKVCache.create(hp.decoder_layers, 2, 32, hp.kv_heads, hp.head_dim,
                         quantized=True, device="cpu")
    ref, jc = jdec.decoder_forward(spec_j, params_j, jnp.asarray(tokens),
                                   jnp.asarray(pos), jc)
    got, tc = tdec.decoder_forward(spec_t, params_t,
                                   torch.from_numpy(tokens),
                                   torch.from_numpy(pos.copy()), tc)
    assert got.shape == (2, 12, hp.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    _compare_caches(jc, tc)


def test_decode_step_matches_jax(models):
    """One batched decode step at per-slot lengths (12 and 9) through the
    per-layer loop: logits and the appended cache rows."""
    spec_j, params_j, spec_t, params_t = models
    hp = spec_t.hyper_params
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, hp.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jc = JKVCache.create(hp.decoder_layers, 2, 32, hp.kv_heads, hp.head_dim,
                         quantized=True)
    tc = TKVCache.create(hp.decoder_layers, 2, 32, hp.kv_heads, hp.head_dim,
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
    ref = jdec.output_logits(spec_j, params_j, xj)
    xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(step),
                           torch.from_numpy(spos))
    xt, tc = tdec.decoder_layers_unrolled(spec_t, params_t["layers"], xt,
                                          torch.from_numpy(spos), tc)
    got = tdec.output_logits(spec_t, params_t, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    _compare_caches(jc, tc)


def test_chunk_loop_matches_jax(models):
    """Chunked prefill of one slot (two chunks of 8) against the JAX chunk
    loop: logits of the last chunk and the slot's cache rows."""
    spec_j, params_j, spec_t, params_t = models
    hp = spec_t.hyper_params
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, hp.vocab_size, (1, 16)).astype(np.int32)
    jc = JKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads, hp.head_dim,
                         quantized=True)
    tc = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads, hp.head_dim,
                         quantized=True, device="cpu")
    for start in (0, 8):
        chunk = prompt[:, start:start + 8]
        pos = start + np.arange(8, dtype=np.int32)[None]
        xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(chunk),
                               jnp.asarray(pos))
        xj, jc = jdec.decoder_layers_chunk(spec_j, params_j["layers"], xj,
                                           jnp.asarray(pos), jc, 1, start)
        xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(chunk),
                               torch.from_numpy(pos))
        xt, tc = tdec.decoder_layers_chunk(spec_t, params_t["layers"], xt,
                                           torch.from_numpy(pos), tc, 1,
                                           start)
    ref = jdec.output_logits(spec_j, params_j, xj)
    got = tdec.output_logits(spec_t, params_t, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    _compare_caches(jc, tc)


def test_unported_configurations_raise():
    """Heterogeneous MoE stacks and ALiBi raise; the q8c and mixed layouts,
    unported until the Q8 block kernels, now build (their numbers:
    tests/test_torch_q8.py), and so do MoE models with every layer routed,
    unported until routed MoE (their numbers: tests/test_torch_moe.py)."""
    for layout in ("q8c", "mixed"):
        spec = tzoo.make_spec("test-tiny", device_layout=layout)
        params = tzoo.make_synthetic_params(spec, "Q4_B64T1", device="cpu")
        assert params["layers"][0]["ffn"]["w1n3"].format == "Q8_B32T2"
    moe = tzoo.make_synthetic_params(tzoo.make_spec("test-moe"), "Q4_B64T1",
                                     device="cpu")
    assert "experts_stacked" in moe["layers"][0]["moe"]
    dense_first = tzoo.make_spec("test-moe")
    dense_first.hyper_params.moe_layer_start = 1
    with pytest.raises(NotImplementedError, match="heterogeneous MoE"):
        tzoo.make_synthetic_params(dense_first, "Q4_B64T1", device="cpu")
    alibi = tzoo.make_spec("test-tiny", pos_embedding_alg="alibi")
    with pytest.raises(NotImplementedError):
        tzoo.make_synthetic_params(alibi, device="cpu")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
