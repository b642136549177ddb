"""Paged KV serving on the card: kernel B7, B4's paged mode (f) and a
16-slot paged engine, against their plain versions and the dense path.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run
``python -m pytest -m cuda tests/test_torch_cuda_paged.py``.

Tolerances: B7 and its plain version both compute in float32 and round
once to bf16, so they differ by summation order only: |kernel - plain| <=
8e-3 * max|plain| (two bf16 ulps at the largest output).  B4 (f) against
its plain version: 5e-2 absolute on the hidden state (magnitude ~1), as
dense B4 in tests/test_torch_cuda.py; against dense B4 on the same rows:
equal (both kernels cut the walk by the slots' lengths alone).  The paged
engine against the dense engine: every sampled row is within 5e-2 while
the streams agree; they may part only at a near-tie.
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels.attention import (
    decode_attention, paged_decode_attention_plain)
from inferflow_tpu_torch.kernels.decode_step import (fused_decode_step,
                                                     fused_decode_step_plain)
from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
from inferflow_tpu_torch.runtime.kv_cache import KVCache
from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
FUSED_TOL = 5e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _tables(lengths, pt, maxp, pages, seed):
    order = [int(p) + 1 for p in
             np.random.default_rng(seed).permutation(pages - 1)]
    rows = []
    for n in lengths:
        need = -(-n // pt)
        rows.append(order[:need] + [0] * (maxp - need))
        order = order[need:]
    return rows


def test_paged_attention_kernel(dev):
    """B7 at llama2-7b width (H = 32, g = 1, D = 128) and tinyllama-1.1b
    width (H = 4, g = 8, D = 64), and at D = 32 (g = 4), Q8 and bf16 pools,
    shuffled pages, lengths of 0, one row, a full page and page + 1."""
    for h, g, d in ((32, 1, 128), (4, 8, 64), (2, 4, 32)):
        pt = 128 * max(1, 128 // d)
        lengths = [3 * pt + 5, pt, pt + 1, 1, 0, 2 * pt - 1, 37]
        b = len(lengths)
        for quantized in (True, False):
            cache = PagedKVCache.create(2, b, 4 * pt, h, d,
                                        pool_tokens=40 * pt,
                                        quantized=quantized, device=dev)
            gen = torch.Generator(device=dev).manual_seed(d + quantized)
            if quantized:
                for t in (cache.k, cache.v):
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          device=dev, dtype=torch.int8))
                for t in (cache.k_scale, cache.v_scale):
                    t.copy_(torch.rand(t.shape, generator=gen, device=dev)
                            * 0.05 + 1e-3)
            else:
                for t in (cache.k, cache.v):
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            for slot, row in enumerate(_tables(lengths, pt, 4,
                                               cache.num_pages, d)):
                cache.with_page_row(slot, row)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = (torch.randn((b, 1, h * g, d), generator=gen, device=dev)
                 * 0.3).to(torch.bfloat16)
            before = _build.launch_counts["paged_decode_attention"]
            got, _ = decode_attention(q, cache, 1, lens, kq_scale=1.25)
            ref = paged_decode_attention_plain(q[:, 0], cache, 1, lens, 1.25)
            torch.cuda.synchronize()
            assert _build.launch_counts["paged_decode_attention"] \
                == before + 1
            err = (got[:, 0].float() - ref.float()).abs().max().item()
            assert err <= REL_TOL * ref.float().abs().max().item() + 1e-6, \
                (h, g, d, quantized, err)
            assert not got[lengths.index(0)].any()


def _dense_and_paged(dev, layers, lengths, h, d, s, seed):
    """A dense Q8 cache with random rows and a pool holding the same rows on
    shuffled pages."""
    b = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = KVCache.create(layers, b, s, h, d, quantized=True, device=dev)
    for layer in range(layers):
        k = torch.randn((b, s, h, d), generator=gen, device=dev)
        v = torch.randn((b, s, h, d), generator=gen, device=dev)
        dense.update_layer(layer, k, v, torch.zeros(b, dtype=torch.int32,
                                                    device=dev))
    dense.with_length(torch.tensor(lengths, device=dev))
    paged = PagedKVCache.create(layers, b, s, h, d,
                                pool_tokens=(b * -(-s // 128) + 5) * 128
                                * max(1, 128 // d),
                                quantized=True, device=dev)
    pt, maxp = paged.page_tokens, paged.max_pages_per_slot
    for slot, row in enumerate(_tables([s] * b, pt, maxp, paged.num_pages,
                                       seed)):
        paged.with_page_row(slot, row)
        for j, pid in enumerate(row):
            for src, dst in ((dense.k, paged.k), (dense.v, paged.v),
                             (dense.k_scale, paged.k_scale),
                             (dense.v_scale, paged.v_scale)):
                dst[:, pid] = src[:, slot, :, j * pt:(j + 1) * pt]
    paged.with_length(dense.length.clone())
    return dense, paged, gen


def test_paged_fused_step_kernel(dev):
    """B4 (f) against its plain version at test-llama width (3 layers) and
    tinyllama-1.1b width (2 layers), B = 1 and B = 4 (a slot at length 0,
    one at the last row); and against dense B4 on the same rows: the same
    hidden state and appended rows."""
    for name, layers, s in (("test-llama", 3, 1024),
                            ("tinyllama-1.1b", 2, 1024)):
        spec = make_spec(name, layers=layers)
        params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev)
        hp = spec.hyper_params
        for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
            dense, paged, gen = _dense_and_paged(
                dev, layers, lengths, hp.kv_heads, hp.head_dim, s, 7)
            twin = dataclasses.replace(
                paged, k=paged.k.clone(), v=paged.v.clone(),
                k_scale=paged.k_scale.clone(), v_scale=paged.v_scale.clone())
            x = (torch.randn((len(lengths), 1, hp.embd_dims), generator=gen,
                             device=dev) * 0.5).to(torch.bfloat16)
            pos = dense.length[:, None]
            before = _build.launch_counts["fused_decode_step"]
            got, _ = fused_decode_step(spec, params["layers"], x, pos, paged)
            got_d, _ = fused_decode_step(spec, params["layers"], x, pos,
                                         dense)
            ref, _ = fused_decode_step_plain(spec, params["layers"], x, pos,
                                             twin)
            torch.cuda.synchronize()
            assert _build.launch_counts["fused_decode_step"] == before + 2
            assert (got.float() - ref.float()).abs().max().item() \
                <= FUSED_TOL, (name, lengths)
            assert torch.equal(got, got_d), (name, lengths)
            for layer in range(layers):
                for a, r, t in zip(paged.read_layer(layer, torch.float32),
                                   dense.read_layer(layer, torch.float32),
                                   twin.read_layer(layer, torch.float32)):
                    for slot, n in enumerate(lengths):
                        assert torch.equal(a[slot, n], r[slot, n])
                        step = t[slot, n].abs().amax(dim=-1) / 127.0
                        assert torch.all((a[slot, n] - t[slot, n]).abs()
                                         .amax(dim=-1) <= step + FUSED_TOL)


def test_paged_engine_matches_dense_on_card(dev):
    """A 16-slot paged engine (per-layer decode: B7 in every layer) against
    the dense engine (B2) at test-llama width, 20 queries admitted as slots
    free up, whole-prompt prefill on both sides."""
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    spec = make_spec("test-llama")
    params = make_synthetic_params(spec, "Q4_B64T1", seed=1, device=dev)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 512, n)]
               for n in (5, 700, 40, 300, 9, 1000, 64, 129, 17, 513) * 2]
    outs, rows = [], []
    for paging in (False, True):
        eng = InferenceEngine(spec, params, max_concurrent_queries=16,
                              max_context_len=2048, kv_cache_quantized=True,
                              device=dev, kv_cache_paging=paging,
                              kv_pool_tokens=40 * 512)
        eng.prefill_chunk = 2048
        seen = {}
        choose = eng.strategies.choose_token

        def record(qid, logits, prev=(), seen=seen, choose=choose):
            seen.setdefault(qid, []).append(np.asarray(logits).copy())
            return choose(qid, logits, prev)

        eng.strategies.choose_token = record
        queue, qids = list(prompts), []
        _build.launch_counts.clear()
        while queue or eng.has_work():
            while queue:
                qid = eng.add_query(queue[0],
                                    SamplingOptions(strategy="greedy"), 8)
                if qid == -1:
                    break
                qids.append(qid)
                queue.pop(0)
            eng.commit_inference_result(eng.infer())
        torch.cuda.synchronize()
        key = "paged_decode_attention" if paging else "decode_attention"
        assert _build.launch_counts[key] > 0
        assert _build.launch_counts["fused_decode_step"] == 0
        outs.append([eng.query_tokens(q) for q in qids])
        rows.append([seen[q] for q in qids])
    for i, (a, b) in enumerate(zip(*outs)):
        assert len(a) == len(b) == 8
        for j, (ta, tb) in enumerate(zip(a, b)):
            assert np.abs(rows[1][i][j] - rows[0][i][j]).max() <= 5e-2
            if ta != tb:  # only at a near-tie of the dense engine's row
                top2 = np.sort(rows[0][i][j])[-2:]
                assert top2[1] - top2[0] <= 1e-1, (i, j)
                break
