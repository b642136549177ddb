"""The port's zoo gate: every decoder spec of tests/test_model_zoo.py's ZOO
that the port admits (models/decoder.check_supported) loads its synthetic
2-layer checkpoint through both packages' ``load_model`` on the CPU, and
the port's ``decoder_forward`` logits equal the JAX decoder's bit for bit.
The checkpoints and their configs come from that file (``ZOO``,
``_write_checkpoint``), unchanged.

Beside it, the two ops whose rounding the gate caught: the port's gelu
against ``jax.nn.gelu(approximate=True)`` on bf16 inputs, and a bf16
tensor times a Python scalar that bf16 does not hold exactly (JAX rounds
the scalar to bf16 first, weak typing).  Both exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.config.model_spec import load_model_spec as jax_spec
from inferflow_tpu.loaders.model_loader import load_model as jax_load
from inferflow_tpu.models.decoder import decoder_forward as jax_forward
from inferflow_tpu_torch.config.model_spec import load_model_spec
from inferflow_tpu_torch.loaders.model_loader import load_model
from inferflow_tpu_torch.models.decoder import (check_supported,
                                                decoder_forward)
from inferflow_tpu_torch.ops.activations import activate, weak_scalar
from test_model_zoo import CONFIG_DIR, HD, ZOO, _write_checkpoint

TOKENS = [[3, 5, 9, 2]]
# the zoo's decoder specs that the port refuses (check_supported): ALiBi,
# a heterogeneous MoE stack, parallel attention
REFUSED = {"baichuan2_13b_chat", "bloomz_3b", "deepseek_moe_16b_base",
           "falcon_7b_instruct", "falcon_40b_instruct", "phi_2"}


def _prepare(spec):
    """test_model_zoo's adjustments of a production spec to the synthetic
    checkpoint (dense weights, the checkpoint's vocab and experts)."""
    spec.device_weight_data_type = "Q8_B32T1"
    spec.tensor_quant_threshold = 10 ** 9
    if spec.hyper_params.experts:
        spec.hyper_params.experts = 0
        spec.hyper_params.moe_top_k = 0
    spec.hyper_params.vocab_size = 0
    spec.hyper_params.padded_vocab_size = 0
    if spec.rope_dim > HD:
        spec.rope_dim = HD // 2
    return spec


def test_zoo_decoders_match_jax(tmp_path):
    """All 21 admitted decoder specs, gemma_2b_it (gelu) and
    minicpm_2b_dpo_bf16 (out_scale 0.111111) among them: logits (1, 4, V)
    float32 equal."""
    matched, refused = [], set()
    for name in sorted(ZOO):
        builder, config, kind = ZOO[name]
        if kind != "decoder":
            continue
        path = os.path.join(CONFIG_DIR, name, "model_spec.json")
        spec = load_model_spec(path, sid=name)
        try:
            check_supported(spec)
        except NotImplementedError:
            refused.add(name)
            continue
        _prepare(spec)
        d = tmp_path / name
        d.mkdir()
        with open(d / (spec.config_file or "config.json"), "w") as fh:
            json.dump(config, fh)
        # the JAX zoo test's seed for this spec (str hashes vary by
        # process; any seed will do, the same for both packages)
        rng = np.random.default_rng(sum(map(ord, name)))
        jspec = _prepare(jax_spec(path, sid=name))
        _write_checkpoint(d, jspec, builder(rng))
        params = load_model(spec, str(d), device="cpu")
        tokens = torch.tensor(TOKENS)
        got, _ = decoder_forward(spec, params, tokens,
                                 torch.arange(4)[None, :])
        jparams = jax_load(jspec, str(d))
        want, _ = jax_forward(jspec, jparams, jnp.asarray(TOKENS, jnp.int32),
                              jnp.arange(4)[None, :], None)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        matched.append(name)
    assert refused == REFUSED
    assert len(matched) == 21 and {"gemma_2b_it",
                                   "minicpm_2b_dpo_bf16"} <= set(matched)


def test_gelu_matches_jax_on_bf16():
    """100,000 bf16 values (normal, sd 3): the port's gelu, alone and as
    glu_gelu's activation, equals jax.nn.gelu(approximate=True) op by op
    in bf16."""
    rng = np.random.default_rng(14)
    x = (rng.standard_normal(100_000) * 3).astype(np.float32)
    g = rng.standard_normal(100_000).astype(np.float32)
    xt, gt = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, g))
    xj, gj = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, g))
    want = np.asarray(jax.nn.gelu(xj, approximate=True), np.float32)
    np.testing.assert_array_equal(activate("gelu", xt).float().numpy(), want)
    want_glu = np.asarray(jax.nn.gelu(xj, approximate=True) * gj, np.float32)
    np.testing.assert_array_equal(
        activate("glu_gelu", xt, gt).float().numpy(), want_glu)


def test_scalar_scale_rounds_like_jax():
    """bf16 times 0.111111 (minicpm's out_scale, not exact in bf16) and
    times 12 and 0.25 (exact): the port's weak_scalar product equals JAX's
    bf16 * Python float; the full-precision torch product differs.
    weak_scalar gives a Python float."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal(100_000).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
        x).astype(jnp.bfloat16)
    for s in (0.111111, 12.0, 0.25):
        want = np.asarray(xj * s, np.float32)
        # a Python float, rounded on the host: no tensor, no copy to a card
        assert type(weak_scalar(s, xt)) is float
        got = (xt * weak_scalar(s, xt)).float().numpy()
        np.testing.assert_array_equal(got, want)
        if s == 0.111111:
            assert ((xt * s).float().numpy() != want).any()
