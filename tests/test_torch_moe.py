"""The port's routed MoE (the MoE block, expert stacks, kernel B4's mode
(g)) against the JAX package, on the CPU.

Models: ``make_spec("test-moe")`` (E = 64, 4 experts, top-2) for the
per-layer block and the engines on their per-layer path, and
``make_spec("test-moe", embd=128, inter=256)`` (the JAX kernel's 128-lane
minimum) for the fused step.  Weights are the JAX package's synthetic
ones (``make_synthetic_params``), moved over with
``weights.params_from_numpy``; the JAX fused step runs its Pallas kernel
with ``interpret=True``.

Tolerances:
  - ``moe_block`` (both routes: routed decode when B * top_k < E, the
    one-hot combine otherwise): two bf16 steps of max|JAX| (the same
    routing and products; measured: equal, or one step where a float32
    sum order differs);
  - the plain B4 (g) step: norm-rmsd of the hidden state below 0.01 (the
    JAX tests hold its fused MoE step to 0.03 and 0.05 against its own
    per-layer path).  Measured 0.0 for i8mm and i4 experts (the same
    integer products), 0.0054 for Q8_B32T2 (the interpreter keeps the
    product q * bf16(scale) in float32 where the kernel rounds it to bf16,
    ROADMAP C3);
  - engines: the rule of tests/test_torch_engine.py, greedy streams equal
    up to a near-tie of the JAX logits, and logits rows within
    ENGINE_LOGIT_TOL = 5e-2 on the per-layer path (measured 0.012) and
    I8MM_ENGINE_TOL = 0.1 on the fused path with i8mm weights: the JAX
    engine prefills with its scanned forward, which on this model differs
    from its unrolled decoder_forward (the port's prefill equals the
    latter exactly) by 0.066 on the first sampled row (ROADMAP C6; the
    dense test-llama model differs by 0.025), and that row's cache rows
    carry 0.03-0.04 into every later row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.config import load_engine_config
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches
from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _interleaved, _record_rows

STEP_NRMSD = 0.01
ENGINE_LOGIT_TOL = 5e-2
I8MM_ENGINE_TOL = 0.1
WIDE = dict(embd=128, inter=256)  # the JAX fused kernel's lane minimum


def norm_rmsd(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return np.sqrt(((a - b) ** 2).mean()) / (np.sqrt((b * b).mean()) + 1e-9)


def _models(fmt, layout, seed=1, stacked=True, **dims):
    spec_j = jzoo.make_spec("test-moe", device_layout=layout or "packed",
                            **dims)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=seed,
                                          stacked=stacked,
                                          device_layout=layout)
    spec_t = tzoo.make_spec("test-moe", device_layout=layout or "packed",
                            **dims)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


def _bf16_steps(ref, n=2):
    """n bf16 steps of the largest |ref|."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max() + 1e-30)) - 7)


@pytest.mark.parametrize("fmt,layout", [(None, ""), ("Q4_B64T1", "packed"),
                                        ("Q4_B64T1", "i8mm")],
                         ids=["dense", "Q4_B64T1", "i8mm"])
def test_moe_block_matches_jax(fmt, layout, monkeypatch):
    """moe_block on layer 0 of a layer-stacked JAX tree: B = 1 (routed:
    only the chosen experts run), B = 3 and a 5-token prefill (the one-hot
    combine over every expert)."""
    spec_j, params_j, spec_t, params_t = _models(fmt, layout)
    moe_j = jdec._index_layer(params_j["layers"], 0)["moe"]
    moe_t = params_t["layers"][0]["moe"]
    assert "experts_stacked" in moe_t and "experts" not in moe_t
    top_k = spec_t.hyper_params.moe_top_k
    rng = np.random.default_rng(0)
    calls = []
    real = tdec.index_expert
    monkeypatch.setattr(tdec, "index_expert",
                        lambda s, e: calls.append(e) or real(s, e))
    for b, t in ((1, 1), (3, 1), (2, 5)):
        x = rng.standard_normal((b, t, 64)).astype(np.float32)
        ref = np.asarray(jdec.moe_block(
            spec_j, moe_j, jnp.asarray(x).astype(jnp.bfloat16),
            use_pallas=False), np.float32)
        calls.clear()
        got = tdec.moe_block(spec_t, moe_t,
                             torch.from_numpy(x).to(torch.bfloat16))
        routed = t == 1 and b * top_k < 4
        assert len(calls) == (b * top_k if routed else 4), (b, t, calls)
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - ref).max() <= _bf16_steps(ref)


def test_expert_stacks_carry_across():
    """JAX trees with expert stacks, per-layer lists and layer-stacked
    ((L, E, K, N) leaves), cross with the L axis stripped and the E axis
    kept, byte for byte; index_expert gives 2-D views; stacking an expert
    list and fusing w1|w3 on stacked leaves give the same bytes as per
    expert."""
    for layout in ("i8mm", "packed"):
        spec_j = jzoo.make_spec("test-moe", device_layout=layout)
        listed = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=4,
                                            device_layout=layout)
        stacked = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=4,
                                             stacked=True,
                                             device_layout=layout)
        for tree in (listed, stacked):
            np_tree = jax_params_to_numpy(tree)
            params = params_from_numpy(np_tree, tzoo.make_spec("test-moe"),
                                       device="cpu")
            for i, lp in enumerate(params["layers"]):
                ref = jax_params_to_numpy(
                    jdec._index_layer(stacked["layers"], i))["moe"]
                got = lp["moe"]
                np.testing.assert_array_equal(
                    got["gate"].float().numpy(),
                    np.asarray(ref["gate"], np.float32))
                for name, w in got["experts_stacked"].items():
                    r = ref["experts_stacked"][name]
                    assert tuple(w.shape) == tuple(r["shape"]) == (
                        4,) + tuple(w.select(0).shape)
                    if layout == "i8mm":
                        np.testing.assert_array_equal(w.data.numpy(),
                                                      r["data"])
                        np.testing.assert_array_equal(w.scale.numpy(),
                                                      r["scale"])
                    else:
                        for k, p in w.planes.items():
                            np.testing.assert_array_equal(p.numpy(),
                                                          r["planes"][k])
                        np.testing.assert_array_equal(w.scale.numpy(),
                                                      r["scale"])
            st = params["layers"][0]["moe"]["experts_stacked"]
            one = tdec.index_expert(st, 2)
            w1n3 = one["w1n3"]
            data = w1n3.data if layout == "i8mm" else w1n3.planes["data"]
            assert data.dim() == 2 and data.data_ptr() == (
                (st["w1n3"].data if layout == "i8mm"
                 else st["w1n3"].planes["data"])[2].data_ptr())
        # a list of experts stacks back to the stack; w1 | w3 fused on the
        # stacked leaves equals each expert's own fusion
        layer = {"moe": {"experts": [tdec.index_expert(st, e)
                                     for e in range(4)]}}
        tdec.stack_moe_experts([layer])
        again = layer["moe"]["experts_stacked"]
        inter = spec_j.hyper_params.decoder_intermediate_size

        def cols(w, lo, hi):
            if isinstance(w, codec_torch.Int8MXUTensor):
                return codec_torch.Int8MXUTensor(
                    tuple(w.shape[:-1]) + (hi - lo,), w.data[..., lo:hi],
                    w.scale[..., lo:hi])
            return codec_torch.QuantizedTensor(
                w.format, tuple(w.shape[:-1]) + (hi - lo,),
                {k: p[..., lo:hi] for k, p in w.planes.items()},
                w.scale[..., lo:hi], w.base[..., lo:hi])

        split = {"w1": cols(st["w1n3"], 0, inter),
                 "w3": cols(st["w1n3"], inter, 2 * inter), "w2": st["w2"]}
        fused = tdec.fuse_layer_weights(
            [{"attn": {}, "moe": {"experts_stacked": split}}])[0]
        for w in (again["w1n3"], fused["moe"]["experts_stacked"]["w1n3"]):
            assert tuple(w.shape) == tuple(st["w1n3"].shape)
            for e in range(4):
                a, r = w.select(e), st["w1n3"].select(e)
                for ta, tr in ((a.scale, r.scale),) + (
                        ((a.data, r.data),) if layout == "i8mm" else
                        tuple((a.planes[k], r.planes[k]) for k in r.planes)):
                    assert torch.equal(ta, tr)


def test_fused_moe_step_matches_jax():
    """The plain B4 (g) step against JAX fused_decode_step(interpret=True)
    at B = 1, 2 and 8 with i8mm and Q8_B32T2 experts, and at B = 2 with
    i4 experts; the step is the route decoder_layers_unrolled takes.  A
    MoE stack the TPU kernel does not fuse (a shared expert) is neither
    supported nor run; one it fuses past the port's expert cap raises in
    both."""
    cases = [("Q4_B64T1", "i8mm", ([9], [4, 21], [3, 9, 4, 2, 6, 0, 11, 5])),
             ("Q8_B32T2", "packed", ([9], [4, 21],
                                     [3, 9, 4, 2, 6, 0, 11, 5])),
             ("Q4_B64T1", "i4", ([4, 21],))]
    for fmt, layout, runs in cases:
        spec_j, params_j, spec_t, params_t = _models(fmt, layout, seed=2,
                                                     **WIDE)
        hp = spec_t.hyper_params
        for lengths in runs:
            jc, tc = _caches(spec_j, spec_t, lengths, 5)
            b = len(lengths)
            assert jds.fused_step_supported(spec_j, params_j["layers"], jc, b)
            assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
            x = (np.random.default_rng(1).standard_normal(
                (b, 1, hp.embd_dims)) * 0.3).astype(np.float32)
            pos = np.asarray(lengths, np.int32)[:, None]
            ref, _ = jds.fused_decode_step(
                spec_j, params_j["layers"], jnp.asarray(x).astype(jnp.bfloat16),
                jnp.asarray(pos), jc, interpret=True)
            got, tc = tdec.decoder_layers_unrolled(
                spec_t, params_t["layers"], torch.from_numpy(x).to(
                    torch.bfloat16), torch.from_numpy(pos), tc)
            err = norm_rmsd(got.float().numpy(), ref)
            assert err < STEP_NRMSD, (fmt, layout, lengths, err)

    tc = TKVCache.create(hp.decoder_layers, 2, 64, hp.kv_heads, hp.head_dim,
                         quantized=True, device="cpu")
    x = torch.zeros((2, 1, hp.embd_dims), dtype=torch.bfloat16)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    layers = params_t["layers"]
    shared = [dict(lp, moe=dict(lp["moe"], shared=tdec.index_expert(
        lp["moe"]["experts_stacked"], 0))) for lp in layers]
    assert not tds.fused_step_supported(spec_t, shared, tc, 2)
    with pytest.raises(NotImplementedError, match="fused_decode_step serves"):
        tds.fused_decode_step(spec_t, shared, x, pos, tc)
    y, _ = tdec.decoder_layers_unrolled(spec_t, shared, x, pos, tc)
    assert torch.isfinite(y.float()).all()
    # 65 experts (the expert axis repeated; only the shapes are read)
    wide = [dict(lp, moe=dict(lp["moe"], gate=torch.zeros(
        (hp.embd_dims, 65), dtype=torch.bfloat16), experts_stacked={
            k: _with_experts(w, 65)
            for k, w in lp["moe"]["experts_stacked"].items()}))
        for lp in layers]
    with pytest.raises(NotImplementedError, match="at most 64 experts"):
        tds.fused_step_supported(spec_t, wide, tc, 2)
    with pytest.raises(NotImplementedError, match="at most 64 experts"):
        tds.fused_decode_step(spec_t, wide, x, pos, tc)


def _with_experts(w, n):
    """w with its expert axis repeated to n entries (only shapes matter)."""
    if isinstance(w, codec_torch.Int8MXUTensor):
        return codec_torch.Int8MXUTensor(
            (n,) + tuple(w.shape[1:]), w.data[:1].expand(n, -1, -1),
            w.scale[:1].expand(n, -1))
    return codec_torch.QuantizedTensor(
        w.format, (n,) + tuple(w.shape[1:]),
        {k: p[:1].expand(n, -1, -1) for k, p in w.planes.items()},
        w.scale[:1].expand(n, -1, -1),
        None if w.base is None else w.base[:1].expand(n, -1, -1))


def test_routing_ties_and_norm_topk():
    """Ties go to the lower expert (as jax.lax.top_k and the TPU kernel's
    argmax loop break them), in the per-layer top-k and in mode (g)'s
    routing; moe_norm_top_k_prob off keeps the raw probabilities, in both
    packages' moe_block."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(probs), 2)
    vals_t, idx_t = tdec.top_k_lowest(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t.numpy(), [[1, 2], [0, 1], [0, 2]])
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    # mode (g): experts 1 and 3 share a gate column with 0 and 2
    g = torch.randn(64, 4).to(torch.bfloat16)
    g[:, 1], g[:, 3] = g[:, 0], g[:, 2]
    xn = torch.randn(5, 64).to(torch.bfloat16)
    for norm in (True, False):
        sel, w = tds.moe_route_plain(xn, g, 2, norm)
        logits = xn.float() @ g.float()
        lower = torch.where(logits[:, 0] >= logits[:, 2], 0, 2)
        assert torch.equal(sel[:, 0].long(), lower)
        assert torch.equal(sel[:, 1].long(), lower + 1)
        p = torch.softmax(logits, -1)
        raw = p.gather(1, sel.long())
        ref = raw / raw.sum(-1, keepdim=True) if norm else raw
        torch.testing.assert_close(w, ref, rtol=1e-6, atol=1e-7)
        xn2, sel2, w2 = tds.moe_route(xn, torch.ones(64, dtype=torch.bfloat16),
                                      g, 2, norm, 1e-5)
        assert xn2.shape == xn.shape and sel2.shape == (5, 2)
    # moe_norm_top_k_prob = False in both packages' moe_block
    spec_j, params_j, spec_t, params_t = _models("Q4_B64T1", "packed")
    spec_j.hyper_params.moe_norm_top_k_prob = False
    spec_t.hyper_params.moe_norm_top_k_prob = False
    moe_j = jdec._index_layer(params_j["layers"], 1)["moe"]
    moe_t = params_t["layers"][1]["moe"]
    x = np.random.default_rng(3).standard_normal((2, 3, 64)).astype(np.float32)
    ref = np.asarray(jdec.moe_block(spec_j, moe_j,
                                    jnp.asarray(x).astype(jnp.bfloat16),
                                    use_pallas=False), np.float32)
    got = tdec.moe_block(spec_t, moe_t, torch.from_numpy(x).to(torch.bfloat16))
    assert np.abs(got.float().numpy() - ref).max() <= _bf16_steps(ref)


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """The JAX engine's fused decode path on the CPU: forced on, its Pallas
    kernel in interpret mode."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    yield
    jds.enable_mega()


def test_moe_engines_match_jax(jax_fused_interpret, monkeypatch):
    """Greedy streams and logits rows of both engines: test-moe from Q4
    wire planes on the per-layer path with 1 slot (routed decode) and 3
    slots (the one-hot combine); the wide test-moe in i8mm with 2 slots on
    both fused steps (B4 (g)), one prompt taking two 32-token chunks.  The
    i8mm model has 4 layers: the JAX engine's scanned prefill counts an
    Int8MXUTensor expert stack's experts from its static shape, whose
    leading axis inside lax.scan is still the layer count, so with fewer
    layers than experts it drops experts (ROADMAP C10)."""
    calls = []
    real = tdec.fused_decode_step
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for fmt, layout, slots, dims in (("Q4_B64T1", "packed", 1, {}),
                                     ("Q4_B64T1", "packed", 3, {}),
                                     ("Q4_B64T1", "i8mm", 2,
                                      dict(WIDE, layers=4))):
        spec_j, params_j, spec_t, params_t = _models(fmt, layout, seed=6,
                                                     **dims)
        je = JEngine(spec_j, params_j, max_concurrent_queries=slots,
                     max_context_len=128, kv_cache_quantized=True)
        te = TEngine(spec_t, params_t, max_concurrent_queries=slots,
                     max_context_len=128, kv_cache_quantized=True,
                     device="cpu")
        je.prefill_chunk = te.prefill_chunk = 32
        jr, tr = _record_rows(je), _record_rows(te)
        rng = np.random.default_rng(slots)
        vocab = spec_t.hyper_params.vocab_size
        prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
                   [int(t) for t in rng.integers(1, vocab, 40 if slots > 1
                                                 else 9)])
        calls.clear()
        if slots == 1:
            ref = {1: je.generate(prompts[0], JOpts(strategy="greedy"), 8)}
            got = {1: te.generate(prompts[0], TOpts(strategy="greedy"), 8)}
        else:
            ref = _interleaved(je, JOpts(strategy="greedy"), prompts,
                               steps_before_second=1)
            got = _interleaved(te, TOpts(strategy="greedy"), prompts,
                               steps_before_second=1)
        assert (len(calls) >= 8) == (layout == "i8mm"), (layout, calls)
        tol = I8MM_ENGINE_TOL if layout == "i8mm" else ENGINE_LOGIT_TOL
        for q in got:
            assert len(got[q]) == len(ref[q]) == 8
            for i, (a, b) in enumerate(zip(got[q], ref[q])):
                np.testing.assert_allclose(tr[q][i], jr[q][i], atol=tol)
                if a != b:  # only at a near-tie of the JAX engine's logits
                    top2 = np.sort(jr[q][i])[-2:]
                    assert top2[1] - top2[0] <= 2 * tol, (i, q)
                    break


def test_mixtral_layout_and_ini(monkeypatch):
    """mixtral-8x7b on an 80 GB card resolves to i8mm with its experts
    counted (about 47.6 GB, under 75%); configs/inferflow_service.moe.ini
    is inferflow_service.ini's deployment with mixtral; the port accepts
    the MoE spec and refuses a heterogeneous stack, naming it."""
    monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                        lambda dev: 80 * 10 ** 9)
    spec = tzoo.make_spec("mixtral-8x7b")
    assert codec_torch.resolve_auto_layout(spec, "Q4_B64T1", "cuda") == "i8mm"
    monkeypatch.setattr(codec_torch, "_device_memory_bytes",
                        lambda dev: 60 * 10 ** 9)
    assert codec_torch.resolve_auto_layout(spec, "Q4_B64T1", "cuda") == "i4"
    hp = spec.hyper_params
    e, f = hp.embd_dims, hp.decoder_intermediate_size
    layer_params = (e * (hp.decoder_heads + 2 * hp.kv_heads) * hp.head_dim
                    + hp.decoder_heads * hp.head_dim * e + 8 * 3 * e * f)
    i8mm_bytes = (hp.decoder_layers * layer_params + hp.vocab_size * e) \
        * 65 // 64 + 2 * hp.vocab_size * e
    assert 47.0e9 < i8mm_bytes < 48.0e9
    cfg = load_engine_config("configs/inferflow_service.moe.ini")
    m = cfg.model
    assert cfg.max_concurrent_queries == 8
    assert m.sid == "mixtral_8x7b_instruct" and m.device_layout == ""
    assert (m.device_weight_data_type, m.device_kv_cache_data_type,
            m.max_context_len) == ("Q4", "Q8", 4096)
    assert m.decoder_input_template == "[INST]{query}[/INST]"
    assert (m.hyper_params.experts, m.hyper_params.moe_top_k) == (8, 2)
    tdec.check_supported(spec)
    spec.hyper_params.moe_layer_start = 1
    with pytest.raises(NotImplementedError, match="heterogeneous MoE"):
        tdec.check_supported(spec)
