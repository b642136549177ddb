"""Paged KV serving in the port against the JAX package, on the CPU.

Covers ``config/`` (the ini loader), ``runtime/paged_kv.py``, kernel B7's
plain version (``paged_decode_attention_plain``), the plain B4 step in its
paged mode (f), and the engine's page reservation, release and admission.

Tolerances:
  - config and cache bytes: exact (codes, f16 scales, page tables,
    lengths);
  - B7: one bf16 step of each output (both sides compute in float32 and
    round once to bf16; they differ only in summation order);
  - B4 (f) and the engines: those of tests/test_torch_decode_step.py
    (STEP_TOL_B1 1e-2 at B = 1, STEP_TOL 6e-2 at B = 3, ENGINE_LOGIT_TOL
    5e-2 on logits, streams equal but for near-ties), for the reasons
    given there;
  - the port's paged engine against its own dense engine: the same
    streams and logits within ENGINE_LOGIT_TOL (the two walk the cache in
    other tiles, which moves bf16 roundings of the batched mode).
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from inferflow_tpu.config import load_engine_config as jload
from inferflow_tpu.kernels import attention as jattn
from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime import paged_kv as jpkv
from inferflow_tpu.runtime.engine import InferenceEngine as JEngine
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu.sampling.strategies import SamplingOptions as JOpts
from inferflow_tpu_torch.config import load_engine_config as tload
from inferflow_tpu_torch.kernels import attention as tattn
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.runtime import paged_kv as tpkv
from inferflow_tpu_torch.runtime.engine import InferenceEngine as TEngine
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from inferflow_tpu_torch.runtime.query_state import DECODING, FINISHED
from inferflow_tpu_torch.sampling.strategies import SamplingOptions as TOpts
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import jax_params_to_numpy
from test_torch_engine import _record_rows

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = 6e-2
STEP_TOL_B1 = 1e-2
ENGINE_LOGIT_TOL = 5e-2


@pytest.fixture(scope="module")
def llama():
    """test-llama in i8mm (d = 32: 512-token pages): the JAX layer-stacked
    params and the port's per-layer copy of the same bytes."""
    spec_j = jzoo.make_spec("test-llama", device_layout="i8mm")
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=3,
                                          stacked=True, device_layout="i8mm")
    spec_t = tzoo.make_spec("test-llama", device_layout="i8mm")
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


def _load(fn, path):
    try:
        return fn(str(path))
    except ValueError as e:  # the same refusal on both sides
        return f"ValueError: {e}"


def test_engine_config_matches_jax():
    """Every ini under configs/ loads to the same EngineConfig and model
    specs, field by field (the pipeline ini's inline comment after
    `devices` is refused by both loaders alike)."""
    paths = sorted((ROOT / "configs").glob("*.ini"))
    assert len(paths) == 10
    refused = 0
    for path in paths:
        ref, got = _load(jload, path), _load(tload, path)
        if isinstance(ref, str):
            assert got == ref, path
            refused += 1
            continue
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(ref)]
        for f in dataclasses.fields(ref):
            if f.name != "models":
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
        assert len(got.models) == len(ref.models) >= 1
        for mg, mr in zip(got.models, ref.models):
            assert dataclasses.asdict(mg) == dataclasses.asdict(mr), path
    assert refused == 1
    paged = tload(str(ROOT / "configs" / "inferflow_service.paged.ini"))
    assert (paged.max_concurrent_queries, paged.kv_cache_paging,
            paged.kv_pool_tokens) == (16, True, 131072)
    assert paged.model.max_context_len == 32768
    i4 = tload(str(ROOT / "configs" / "inferflow_service.i4.ini"))
    assert (i4.max_concurrent_queries, i4.kv_cache_paging) == (8, False)
    assert (i4.model.device_layout, i4.model.device_weight_data_type,
            i4.model.device_kv_cache_data_type, i4.model.max_context_len) \
        == ("i4", "Q4", "Q8", 4096)
    q3h = tload(str(ROOT / "configs" / "inferflow_service.q3h.ini"))
    assert (q3h.max_concurrent_queries, q3h.kv_cache_paging) == (8, False)
    assert (q3h.model.sid, q3h.model.device_layout,
            q3h.model.device_weight_data_type,
            q3h.model.device_kv_cache_data_type,
            q3h.model.max_context_len) \
        == ("llama2_13b", "packed", "Q3H", "Q8", 4096)
    q8 = tload(str(ROOT / "configs" / "inferflow_service.q8.ini"))
    assert (q8.max_concurrent_queries, q8.kv_cache_paging) == (8, False)
    assert (q8.model.sid, q8.model.device_layout,
            q8.model.device_weight_data_type,
            q8.model.device_kv_cache_data_type,
            q8.model.max_context_len) \
        == ("llama2_7b", "", "Q8", "Q8", 4096)
    q4b32 = tload(str(ROOT / "configs" / "inferflow_service.q4b32.ini"))
    assert (q4b32.max_concurrent_queries, q4b32.kv_cache_paging) == (8, False)
    assert (q4b32.model.sid, q4b32.model.device_layout,
            q4b32.model.device_weight_data_type,
            q4b32.model.device_kv_cache_data_type,
            q4b32.model.max_context_len) \
        == ("llama2_7b", "i4", "Q4_B32T1A", "Q8", 4096)


def _jax_pool_to_logical(jc):
    """The JAX pool's raw codes and f16 scales in the port's logical page
    layout (L, P, H, PT, D) / (L, P, H, PT, C)."""
    l, p, h, s2, dp = jc.k.shape
    pf = jc.pf
    d = dp // pf
    codes = [np.asarray(a).reshape(l, p, h, s2 * pf, d) for a in (jc.k, jc.v)]
    if jc.k_scale is None:
        return codes, None
    scales = []
    for a in (jc.k_scale, jc.v_scale):
        a = np.asarray(a)
        c = a.shape[3] // pf
        scales.append(a.reshape(l, p, h, pf, c, s2).transpose(0, 1, 2, 5, 3, 4)
                      .reshape(l, p, h, s2 * pf, c))
    return codes, scales


def _fill_pools(jc, tc, rng, quantized=True):
    """The same random pool contents on both sides (codes and scales, or
    bf16 rows), written through each side's own layout."""
    l, p, h, pt, d = tc.k.shape
    pf = jc.pf
    if quantized:
        codes = [rng.integers(-127, 128, (l, p, h, pt, d)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random((l, p, h, pt, d // tc.block)) * 0.05 + 1e-3)
                  .astype(np.float16) for _ in range(2)]
        c = d // tc.block
        packed = [s.reshape(l, p, h, pt // pf, pf, c)
                  .transpose(0, 1, 2, 4, 5, 3)
                  .reshape(l, p, h, pf * c, pt // pf) for s in scales]
        jc = dataclasses.replace(
            jc, k=jnp.asarray(codes[0].reshape(jc.k.shape)),
            v=jnp.asarray(codes[1].reshape(jc.v.shape)),
            k_scale=jnp.asarray(packed[0]), v_scale=jnp.asarray(packed[1]))
        tc.k.copy_(torch.from_numpy(codes[0]))
        tc.v.copy_(torch.from_numpy(codes[1]))
        tc.k_scale.copy_(torch.from_numpy(scales[0]))
        tc.v_scale.copy_(torch.from_numpy(scales[1]))
        return jc
    rows = [rng.standard_normal((l, p, h, pt, d)).astype(ml_dtypes.bfloat16)
            for _ in range(2)]
    jc = dataclasses.replace(jc, k=jnp.asarray(rows[0].reshape(jc.k.shape)),
                             v=jnp.asarray(rows[1].reshape(jc.v.shape)))
    tc.k.copy_(torch.from_numpy(rows[0].astype(np.float32)))
    tc.v.copy_(torch.from_numpy(rows[1].astype(np.float32)))
    return jc


def _twin_pools(layers, batch, max_len, h, d, pages, tables,
                quantized=True):
    """A JAX and a port paged cache with the same geometry and tables."""
    pt = tpkv.page_tokens_for(d)
    jc = jpkv.PagedKVCache.create(layers, batch, max_len, h, d,
                                  pool_tokens=pages * pt, quantized=quantized)
    tc = tpkv.PagedKVCache.create(layers, batch, max_len, h, d,
                                  pool_tokens=pages * pt, quantized=quantized,
                                  device="cpu")
    assert tc.page_tokens == jc.page_tokens and tc.num_pages == jc.num_pages
    assert tc.max_pages_per_slot == jc.max_pages_per_slot
    for slot, row in enumerate(tables):
        jc = jc.with_page_row(slot, np.asarray(row, np.int32))
        tc.with_page_row(slot, row)
    return jc, tc


def test_paged_cache_writes_match_jax():
    """update_layer, append_rows_all_layers_paged and scatter_prefill_pages
    with the same tables leave the same bytes in the pool at D = 32, 64 and
    128, and read_layer gives the same rows."""
    L, B, H = 2, 2, 2
    rng = np.random.default_rng(0)
    for d in (32, 64, 128):
        pt = tpkv.page_tokens_for(d)
        jc, tc = _twin_pools(L, B, 3 * pt, H, d, 8,
                             ([5, 2, 7], [3, 6, 1]))
        # a prefill of pt + 40 rows into slot 1's first two pages
        length = pt + 40
        jtmp = JKVCache.create(L, 1, 2 * pt, H, d, quantized=True)
        ttmp = TKVCache.create(L, 1, 2 * pt, H, d, quantized=True,
                               device="cpu")
        rows = rng.standard_normal((L, 2, 1, length, H, d)).astype(np.float32)
        zero = np.zeros((1,), np.int32)
        for layer in range(L):
            jtmp = jtmp.update_layer(layer, jnp.asarray(rows[layer, 0]),
                                     jnp.asarray(rows[layer, 1]),
                                     jnp.asarray(zero))
            ttmp.update_layer(layer, torch.from_numpy(rows[layer, 0]),
                              torch.from_numpy(rows[layer, 1]),
                              torch.from_numpy(zero))
        jc = jpkv.scatter_prefill_pages(jc, jtmp, jnp.asarray([3, 6]),
                                        jnp.int32(length), slot=1, n_pages=2)
        tpkv.scatter_prefill_pages(tc, ttmp, [3, 6], length, slot=1)
        # decode appends across slot 0's first page boundary
        for r in (pt - 2, pt - 1, pt, pt + 1):
            start = np.asarray([r, length + r - pt + 2], np.int32)
            for layer in range(L):
                k, v = (rng.standard_normal((B, 1, H, d)).astype(np.float32)
                        for _ in range(2))
                jc = jc.update_layer(layer, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(start))
                tc.update_layer(layer, torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(start))
        # the fused step's all-layer append
        start = np.asarray([2 * pt + 5, length + 9], np.int32)
        k, v = (rng.standard_normal((L, B, H, d)).astype(np.float32)
                for _ in range(2))
        jc = jpkv.append_rows_all_layers_paged(
            jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(start))
        tpkv.append_rows_all_layers_paged(tc, torch.from_numpy(k),
                                          torch.from_numpy(v),
                                          torch.from_numpy(start))
        codes, scales = _jax_pool_to_logical(jc)
        for got, ref in zip((tc.k, tc.v, tc.k_scale, tc.v_scale),
                            codes + scales):
            np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tc.page_table.numpy(),
                                      np.asarray(jc.page_table))
        np.testing.assert_array_equal(tc.page_table_host,
                                      np.asarray(jc.page_table))
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
        n = [2 * pt + 6, length + 10]
        for layer in range(L):
            for got, ref in zip(tc.read_layer(layer, torch.float32),
                                jc.read_layer(layer, jnp.float32)):
                for slot in range(B):
                    np.testing.assert_array_equal(
                        got[slot, :n[slot]].numpy(),
                        np.asarray(ref)[slot, :n[slot]])


def test_paged_attention_plain_matches_jax_kernel():
    """B7's plain version against JAX decode_attention(interpret=True) on a
    PagedKVCache: shuffled pages, lengths across page boundaries, a slot of
    one row and an empty one; Q8 and bf16 pools, D = 64 and 128."""
    rng = np.random.default_rng(1)
    L, H, g = 2, 2, 4
    for d in (64, 128):
        pt = tpkv.page_tokens_for(d)
        lengths = np.asarray([pt + 17, 3 * pt, 1, 0, 2 * pt + 5], np.int32)
        tables = ([4, 9, 2], [7, 1, 8], [5, 0, 0], [0, 0, 0], [3, 6, 10])
        for quantized in (True, False):
            jc, tc = _twin_pools(L, len(tables), 3 * pt, H, d, 11, tables,
                                 quantized)
            jc = _fill_pools(jc, tc, rng, quantized)
            q = (rng.standard_normal((len(tables), 1, H * g, d)) * 0.3
                 ).astype(ml_dtypes.bfloat16)
            ref, _ = jattn.decode_attention(
                jnp.asarray(q), jc, 1, jnp.asarray(lengths), kq_scale=0.9,
                interpret=True)
            got, _ = tattn.decode_attention(
                torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16),
                tc, 1, torch.from_numpy(lengths), kq_scale=0.9)
            ref = np.asarray(ref, np.float32)
            got = got.float().numpy()
            step = 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
            assert np.all(np.abs(got - ref) <= step + 1e-30), (d, quantized)
            assert not got[3].any()  # the empty slot: zeros, as in JAX


def test_paged_fused_step_matches_jax(llama, monkeypatch):
    """The plain B4 in paged mode against JAX fused_decode_step
    (interpret=True) on a paged pool: B = 1 and B = 3 (an empty slot on
    the page-0 row, one at the pool's last row), three 512-token pages per
    slot; the hidden state and the appended rows."""
    spec_j, params_j, spec_t, params_t = llama
    hp = spec_t.hyper_params
    rows = {}
    real_j = jpkv.append_rows_all_layers_paged
    real_t = tds.append_rows_all_layers_paged

    def grab(side, real):
        def f(cache, k, v, start):
            rows[side] = (k, v)
            return real(cache, k, v, start)
        return f

    monkeypatch.setattr(jpkv, "append_rows_all_layers_paged",
                        grab("j", real_j))
    monkeypatch.setattr(tds, "append_rows_all_layers_paged",
                        grab("t", real_t))

    @jax.jit
    def step_j(layers, x, pos, cache):
        out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                    interpret=True)
        return out, rows["j"][0], rows["j"][1]

    d = hp.head_dim
    pt = tpkv.page_tokens_for(d)
    rng = np.random.default_rng(4)
    for lengths, tables, tol in (([700], ([6, 2, 4],), STEP_TOL_B1),
                                 ([200, 0, 3 * pt - 1],
                                  ([3, 0, 0], [0, 0, 0], [5, 1, 7]),
                                  STEP_TOL)):
        b = len(lengths)
        jc, tc = _twin_pools(hp.decoder_layers, b, 3 * pt, hp.kv_heads, d, 8,
                             tables)
        jc = _fill_pools(jc, tc, rng)
        lens = np.asarray(lengths, np.int32)
        jc = jc.with_length(jnp.asarray(lens))
        tc.with_length(torch.from_numpy(lens))
        assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
        tokens = rng.integers(0, hp.vocab_size, (b, 1)).astype(np.int32)
        pos = lens[:, None]
        xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                               jnp.asarray(pos))
        xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                               torch.from_numpy(pos))
        (ref, jc), kj, vj = step_j(params_j["layers"], xj, jnp.asarray(pos),
                                   jc)
        got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                        torch.from_numpy(pos), tc)
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape == (b, 1, hp.embd_dims)
        assert np.abs(got.float().numpy() - ref).max() <= tol, lengths
        drift = [np.abs(rows["t"][i].numpy() - np.asarray(r)).max(axis=-1)
                 for i, r in enumerate((kj, vj))]  # (L, B, H)
        assert max(dr.max() for dr in drift) <= tol, lengths
        for layer in range(hp.decoder_layers):
            for a, r, dr in zip(tc.read_layer(layer, torch.float32),
                                jc.read_layer(layer, jnp.float32), drift):
                for slot, n in enumerate(lengths):
                    row_t, row_j = a[slot, n].numpy(), np.asarray(r[slot, n])
                    step = np.abs(row_j).max(axis=-1) / 127.0
                    assert np.all(np.abs(row_t - row_j).max(axis=-1)
                                  <= step + dr[layer, slot] + 1e-6)


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """The JAX engine's fused decode path on the CPU: forced on, its Pallas
    kernel in interpret mode."""
    monkeypatch.setenv("INFERFLOW_MEGA_FORCE", "1")
    monkeypatch.setattr(jds, "fused_decode_step", functools.partial(
        jds.fused_decode_step, interpret=True))
    yield
    jds.enable_mega()


def _serve(eng, opts, prompts, max_new=8):
    qids = [eng.add_query(p, opts, max_new_tokens=max_new) for p in prompts]
    for _ in range(60):
        if not eng.has_work():
            break
        eng.commit_inference_result(eng.infer())
    assert not eng.has_work()
    return {q: eng.query_tokens(q) for q in qids}


def _check_streams(ref_rows, got_rows, ref, got):
    """Logits within ENGINE_LOGIT_TOL while the greedy streams agree; the
    streams may part only at a near-tie of the reference's logits."""
    assert list(ref) == list(got)
    for q in ref:
        assert len(got[q]) == len(ref[q])
        for i, (a, b) in enumerate(zip(got[q], ref[q])):
            np.testing.assert_allclose(got_rows[q][i], ref_rows[q][i],
                                       atol=ENGINE_LOGIT_TOL)
            if a != b:
                top2 = np.sort(ref_rows[q][i])[-2:]
                assert top2[1] - top2[0] <= 2 * ENGINE_LOGIT_TOL, (i, q)
                break


def test_paged_engine_matches_jax(llama, jax_fused_interpret, monkeypatch):
    """The paged engines on test-llama: 9 slots (per-layer decode; the port
    runs B7) and 4 slots (fused decode, B4 (f)); a 5-token prompt and a
    520-token one, whose 529 rows span two pages.  No slot is reused."""
    spec_j, params_j, spec_t, params_t = llama
    vocab = spec_t.hyper_params.vocab_size
    rng = np.random.default_rng(9)
    prompts = ([int(t) for t in rng.integers(1, vocab, 5)],
               [int(t) for t in rng.integers(1, vocab, 520)])
    calls = {"fused": 0, "paged_attention": 0}
    real_fused = tdec.fused_decode_step
    real_attn = tattn.paged_decode_attention_plain

    def count(key, real):
        def f(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(tdec, "fused_decode_step", count("fused", real_fused))
    monkeypatch.setattr(tattn, "paged_decode_attention_plain",
                        count("paged_attention", real_attn))
    for slots in (9, 4):
        calls.update(fused=0, paged_attention=0)
        je = JEngine(spec_j, params_j, max_concurrent_queries=slots,
                     max_context_len=1024, kv_cache_quantized=True,
                     kv_cache_paging=True)
        te = TEngine(spec_t, params_t, max_concurrent_queries=slots,
                     max_context_len=1024, kv_cache_quantized=True,
                     device="cpu", kv_cache_paging=True)
        assert te.cache.num_pages == je.cache.num_pages
        jr, tr = _record_rows(je), _record_rows(te)
        ref = _serve(je, JOpts(strategy="greedy"), prompts)
        got = _serve(te, TOpts(strategy="greedy"), prompts)
        _check_streams(jr, tr, ref, got)
        assert te._slot_pages == {} and sorted(te._free_pages) == \
            sorted(je._free_pages)
        if slots == 9:  # every decode step: B7 in each of the 3 layers
            assert calls["fused"] == 0 and calls["paged_attention"] >= 3 * 7
        else:  # every decode step: B4 (f), no B7
            assert calls["fused"] >= 7 and calls["paged_attention"] == 0
    assert jds.mega_disabled() is None


def test_paged_admission_and_release():
    """A pool of two usable 512-token pages for three slots: the third
    query waits for a page; it gets the first query's released page in its
    own slot while the first slot sits idle, and every stream equals the
    port's dense engine's (the idle slot's throw-away rows go to page 0, not
    into the page the third query now owns).  A query larger than the pool
    raises."""
    spec = tzoo.make_spec("test-llama", device_layout="i8mm")
    params = tzoo.make_synthetic_params(spec, "Q4_B64T1", seed=2,
                                        device="cpu", device_layout="i8mm")
    vocab = spec.hyper_params.vocab_size
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in (4, 9, 30)]
    news = (4, 12, 6)
    opts = TOpts(strategy="greedy")
    outs, rows = [], []
    for paging in (True, False):
        eng = TEngine(spec, params, max_concurrent_queries=3,
                      max_context_len=1024, kv_cache_quantized=True,
                      device="cpu", kv_cache_paging=paging,
                      kv_pool_tokens=3 * 512)
        rows.append(_record_rows(eng))
        qids = [eng.add_query(p, opts, n) for p, n in zip(prompts, news)]
        assert qids == [1, 2, 3]
        waited = idle_reuse = False
        first_pages = None
        for _ in range(40):
            if not eng.has_work():
                break
            eng.commit_inference_result(eng.infer())
            if paging:
                first_pages = first_pages or eng._slot_pages.get(0)
                with eng._lock:
                    pending = [q.query_id for q in eng.table.prefill_pending()]
                waited |= 3 in pending and not eng._free_pages
                if eng.table.get(3).phase == DECODING and \
                        eng.table.get(1).phase == FINISHED:
                    # query 1's slot sits idle with a zeroed row while
                    # query 3 decodes in slot 2 on query 1's released page
                    idle_reuse |= (
                        eng.table.get(3).slot == 2
                        and set(first_pages) <= set(eng._slot_pages[2])
                        and not eng.cache.page_table_host[0].any()
                        and int(eng.cache.length[0]) == 0)
        assert not eng.has_work()
        if paging:
            assert waited and idle_reuse
            assert eng._slot_pages == {} and len(eng._free_pages) == 2
            assert not eng.cache.page_table_host.any()
        outs.append({q: eng.query_tokens(q) for q in qids})
    _check_streams(rows[1], rows[0], outs[1], outs[0])
    assert [len(o) for o in outs[0].values()] == list(news)

    eng = TEngine(spec, params, max_concurrent_queries=2,
                  max_context_len=2048, kv_cache_quantized=True, device="cpu",
                  kv_cache_paging=True, kv_pool_tokens=2 * 512)
    eng.add_query([1, 2, 3], opts, max_new_tokens=1000)  # needs 3 pages
    with pytest.raises(RuntimeError, match="pool only has"):
        eng.infer()
    with pytest.raises(ValueError, match="kv_cache_paging"):
        TEngine(spec, params, device="cpu", kv_cache_paging=True,
                sequence_parallel=2)
