"""The fused decode step's wire mode (kernel B4's single-plane tile with
pk = 8 / bits codes per byte) in the port against the JAX package, on the
CPU.

The sub-byte single-plane wire formats with f16 metadata take it:
Q4_B64T1, Q4_B32T1A/B (pk 2) and Q2_B32T1A/B (pk 4).  Both packages
support it and route it to the per-layer loop unless INFERFLOW_MEGA=2.
Weights: the JAX zoo's test-llama params (3 layers, d = 32, g = 4) under
``device_layout="packed"``, the JAX side layer-stacked, the port's the
same bytes per layer (``weights.params_from_numpy``).  The JAX step runs
its Pallas kernel with ``interpret=True``; the port's, its plain version.

Tolerances (the JAX package's own, tests/test_decode_step.py:72-85, for
its fused step against its per-layer path):
  - the step's hidden state: norm_rmsd within NRMSD_TOL = 3e-2, and the
    hidden state and the float K/V rows it appends within STEP_TOL = 6e-2
    (max abs, values of magnitude ~1).  The interpreter keeps each weight
    q * bf16(scale) in float32 where the TPU kernel, and the port, round
    it to bf16 (ROADMAP C3): about 0.5% of a product's largest output at
    test-llama's widths.  With the interpreter's float32 weights put into
    the port's plain version the two steps agree to the bit at one and
    two layers; at three, a bf16 rounding flips in the last layer.
    Measured over Q4_B64T1, Q4_B32T1B, Q2_B32T1A and Q3H_B64T1 (B = 1, B
    = 2 dense and paged): hidden norm_rmsd 0.019-0.029, max abs 0.006-
    0.043, rows 0.021-0.048;
  - the appended cache rows: within one Q8 step of JAX's, plus the drift
    of the float rows they quantize;
  - the engines under INFERFLOW_MEGA=2: ENGINE_LOGIT_TOL = 5e-2 on logits
    of magnitude ~1, greedy streams equal but for near-ties of the JAX
    engine's logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu.runtime import paged_kv as jpkv
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime import paged_kv as tpkv
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import CACHE_ROWS, _caches
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows
from test_torch_mega_env import jax_mega  # noqa: F401 - a fixture
from test_torch_paged import _fill_pools, _twin_pools

STEP_TOL = 6e-2
NRMSD_TOL = 3e-2
ENGINE_LOGIT_TOL = 5e-2


def models(fmt, layout="packed", biases=(), seed=3):
    """test-llama from the JAX builder in `fmt` under `layout`: (spec_j,
    params_j, spec_t, params_t), with seeded float32 output biases (scale
    0.05) on the products named in `biases`, (L, N) on the JAX side and
    (N,) per layer on the port's."""
    spec_j = jzoo.make_spec("test-llama", device_layout=layout)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=seed,
                                          stacked=True, device_layout=layout)
    spec_t = tzoo.make_spec("test-llama", device_layout=layout)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    if biases:
        rng = np.random.default_rng(11)
        layers_j = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in params_j["layers"].items()}
        for name in biases:
            grp = "attn" if name in ("qkv", "wo") else "ffn"
            n = int(layers_j[grp][name].shape[-1])
            b = (rng.standard_normal((len(params_t["layers"]), n))
                 * 0.05).astype(np.float32)
            layers_j[grp][f"{name}_b"] = jnp.asarray(b)
            for i, lp in enumerate(params_t["layers"]):
                lp[grp][f"{name}_b"] = torch.from_numpy(b[i].copy())
        params_j = dict(params_j, layers=layers_j)
    return spec_j, params_j, spec_t, params_t


def check_step(m, lengths, seed, tol, monkeypatch, tables=None):
    """One decode step of the JAX kernel (interpreted) and of the port's
    plain version on the same weights, caches and tokens, dense or (with
    page `tables`) paged; asserts the hidden state and the appended float
    rows within `tol` and each stored cache row within one Q8 step plus
    that drift.  Returns (hidden error, row error)."""
    spec_j, params_j, spec_t, params_t = m
    hp = spec_t.hyper_params
    rows = {}
    mod_j, name = ((jpkv, "append_rows_all_layers_paged") if tables
                   else (jkv, "append_rows_all_layers"))

    def grab(side, real):
        def f(cache, k, v, start):
            rows[side] = (k, v)
            return real(cache, k, v, start)
        return f

    monkeypatch.setattr(mod_j, name, grab("j", getattr(mod_j, name)))
    monkeypatch.setattr(tds, name, grab("t", getattr(tds, name)))

    @jax.jit
    def step_j(layers, x, pos, cache):
        out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                    interpret=True)
        return out, rows["j"][0], rows["j"][1]

    b = len(lengths)
    lens = np.asarray(lengths, np.int32)
    rng = np.random.default_rng(seed)
    if tables:
        d = hp.head_dim
        pt = tpkv.page_tokens_for(d)
        jc, tc = _twin_pools(hp.decoder_layers, b, 3 * pt, hp.kv_heads, d,
                             8, tables)
        jc = _fill_pools(jc, tc, rng).with_length(jnp.asarray(lens))
        tc.with_length(torch.from_numpy(lens))
    else:
        jc, tc = _caches(spec_j, spec_t, lengths, seed)
    assert jds.fused_step_supported(spec_j, params_j["layers"], jc, b)
    assert tds.fused_step_supported(spec_t, params_t["layers"], tc, b)
    tokens = rng.integers(0, hp.vocab_size, (b, 1)).astype(np.int32)
    pos = lens[:, None]
    xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                           jnp.asarray(pos))
    xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                           torch.from_numpy(pos))
    (ref, jc), kj, vj = step_j(params_j["layers"], xj, jnp.asarray(pos), jc)
    got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                    torch.from_numpy(pos), tc)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (b, 1, hp.embd_dims)
    diff = got.float().numpy() - ref
    err = float(np.abs(diff).max())
    nrmsd = float(np.sqrt((diff ** 2).mean() / (ref ** 2).mean()))
    drift = [np.abs(rows["t"][i].numpy() - np.asarray(r)).max(axis=-1)
             for i, r in enumerate((kj, vj))]  # (L, B, H)
    row_err = float(max(dr.max() for dr in drift))
    assert err <= tol and row_err <= tol and nrmsd <= NRMSD_TOL, (
        lengths, err, row_err, nrmsd)
    for layer in range(hp.decoder_layers):
        for a, r, dr in zip(tc.read_layer(layer, torch.float32),
                            jc.read_layer(layer, jnp.float32), drift):
            for slot, n in enumerate(lengths):
                row = min(n, a.shape[1] - 1)
                row_t, row_j = a[slot, row].numpy(), np.asarray(r[slot, row])
                step = np.abs(row_j).max(axis=-1) / 127.0
                assert np.all(np.abs(row_t - row_j).max(axis=-1)
                              <= step + dr[layer, slot] + 1e-6)
    return err, row_err, nrmsd


def check_engines(m, monkeypatch, must):
    """Both engines serve `m` at 4 slots under INFERFLOW_MEGA=2 (the JAX
    engine's fused path forced on the CPU, jax_mega); every decode step of
    the port takes the fused step in the mode whose plain product `must`
    names; tokens and logits as ENGINE_LOGIT_TOL says."""
    spec_j, params_j, spec_t, params_t = m
    monkeypatch.setenv("INFERFLOW_MEGA", "2")
    steps, products = [], []
    real_step, real_mm = tdec.fused_decode_step, getattr(tds, must)
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    monkeypatch.setattr(tds, must,
                        lambda *a: products.append(1) or real_mm(*a))
    je = JEngine(spec_j, params_j, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True)
    te = TEngine(spec_t, params_t, max_concurrent_queries=4,
                 max_context_len=CACHE_ROWS, kv_cache_quantized=True,
                 device="cpu")
    jr, tr = _record_rows(je), _record_rows(te)
    rng = np.random.default_rng(9)
    vocab = spec_t.hyper_params.vocab_size
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 11)])
    ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                       steps_before_second=1)
    assert len(steps) >= 8 and products  # every decode step fused
    for q in (1, 2):
        assert len(got[q]) == len(ref[q])
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(tr[q][i], jr[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:  # only at a near-tie of the JAX engine's logits
                top2 = np.sort(jr[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break


@pytest.mark.parametrize("fmt,cases", [
    ("Q4_B64T1", (([300], 4), ([200, CACHE_ROWS - 1], 5))),
    ("Q4_B32T1B", (([300], 4),)),
    ("Q2_B32T1A", (([200, CACHE_ROWS - 1], 5),))])
def test_wire_step_matches_jax(fmt, cases, monkeypatch):
    """The plain B4 in wire mode against JAX fused_decode_step
    (interpret=True) in each wire geometry: B = 1 (per-slot attention)
    and B = 2 (batched, one slot at the cache's last row); each B is one
    JAX compile of about 8 s, so the 32-row geometries take one each."""
    m = models(fmt)
    assert tds._mm_mode(m[3]["layers"][0]["attn"]["qkv"]) == "wire"
    for lengths, seed in cases:
        check_step(m, lengths, seed, STEP_TOL, monkeypatch)


def test_wire_step_paged_matches_jax(monkeypatch):
    """The plain B4 in wire mode over a paged pool (mode (f)), B = 2 with
    shuffled pages, against the interpreted JAX kernel."""
    m = models("Q4_B64T1")
    check_step(m, [700, 130], 6, STEP_TOL, monkeypatch,
               tables=([6, 2, 4], [3, 5, 0]))


def test_wire_engine_under_mega_2_matches_jax(jax_mega, monkeypatch):
    """Q4_B64T1 wire planes at 4 slots under INFERFLOW_MEGA=2: the port's
    every decode step takes the fused step's wire mode, as the JAX
    engine's takes its fused step."""
    check_engines(models("Q4_B64T1", seed=3), monkeypatch,
                  "wire_matmul_plain")
