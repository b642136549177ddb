"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: kernel and plain version compute the same float32 arithmetic
(the same bf16-rounded weights for B1, float32 dequantized K/V for B2/B3)
and differ only in summation order, so outputs may differ by about one
bf16 rounding step: |kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps
at the largest output).  The i8mm product and B4 state their own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels.attention import (chunk_attention,
                                                   chunk_attention_plain,
                                                   decode_attention,
                                                   decode_attention_plain)
from inferflow_tpu_torch.kernels.dequant_matmul import (quantized_matmul,
                                                        quantized_matmul_plain)
from inferflow_tpu_torch.quant.codec_torch import quantize
from inferflow_tpu_torch.runtime.kv_cache import KVCache

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= REL_TOL * scale + 1e-6, (err, scale)


def test_dequant_matmul_kernel(dev):
    for k, n in ((512, 256), (2048, 2560), (5632, 2048)):
        _dequant_matmul_case(dev, k, n)


def _dequant_matmul_case(dev, k, n):
    """Each M of the decode (GEMV) and prefill (tiled) paths against the
    plain version; a decode plan that would overflow the x staging buffer
    or leave K uncovered is refused by the C entry."""
    from inferflow_tpu_torch.kernels.dequant_matmul import _lib, matmul_plan
    for m in (1, 4, 8, 9, 130):
        gen = torch.Generator(device=dev).manual_seed(m * 7 + k)
        w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
        qt = quantize(w, "Q4_B64T1")
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        before = _build.launch_counts["dequant_matmul"]
        got = quantized_matmul(x, qt)
        torch.cuda.synchronize()
        assert _build.launch_counts["dequant_matmul"] == before + 1
        _close(got, quantized_matmul_plain(x, qt))

    lib = _lib()
    per, ksplit = matmul_plan(lib, 4, k, n, dev)
    assert 1 <= per <= 8 and per * ksplit >= k // 64 > per * (ksplit - 1)
    x = torch.zeros((4, k), dtype=torch.bfloat16, device=dev)
    out = torch.empty((4, n), dtype=torch.bfloat16, device=dev)
    work = torch.empty((k // 64, 4, n), dtype=torch.float32, device=dev)
    for bad_per, bad_split in ((9, -(-k // 64 // 9)), (1, k // 64 - 1)):
        rc = lib.ift_q4_matmul(
            _build.ptr(x), _build.ptr(qt.planes["data"]), None,
            _build.ptr(qt.scale), _build.ptr(qt.base), _build.ptr(out),
            _build.ptr(work), 4, k, n, bad_per, bad_split, _build.stream_of(x))
        assert rc != 0, (bad_per, bad_split)


def _filled_cache(dev, quantized, layers=3, b=3, h=2, s=512, d=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = KVCache.create(layers, b, s, h, d, quantized=quantized,
                           device=dev)
    for layer in range(layers):
        k = torch.randn((b, s, h, d), generator=gen, device=dev)
        v = torch.randn((b, s, h, d), generator=gen, device=dev)
        cache.update_layer(layer, k, v, torch.zeros(b, dtype=torch.int32,
                                                    device=dev))
    return cache, gen


def test_decode_attention_kernel(dev):
    for quantized in (False, True):
        for g in (1, 8):
            for d in (64, 128):
                cache, gen = _filled_cache(dev, quantized, d=d)
                q = (torch.randn((3, 1, 2 * g, d), generator=gen, device=dev)
                     * 0.3).to(torch.bfloat16)
                lengths = torch.tensor([1, 37, 512], dtype=torch.int32,
                                       device=dev)
                got, _ = decode_attention(q, cache, 2, lengths, kq_scale=1.25)
                torch.cuda.synchronize()
                _close(got[:, 0], decode_attention_plain(q[:, 0], cache, 2,
                                                         lengths, 1.25))


def test_chunk_attention_kernel(dev):
    for quantized in (False, True):
        for g in (1, 8):
            cache, gen = _filled_cache(dev, quantized, seed=1)
            c, start = 96, 64
            q = (torch.randn((1, c, 2 * g, 64), generator=gen, device=dev)
                 * 0.3).to(torch.bfloat16)
            got, _ = chunk_attention(q, cache, 1, 2, start, kq_scale=0.9)
            torch.cuda.synchronize()
            _close(got[0], chunk_attention_plain(q[0], cache, 1, 2, start,
                                                 0.9))


def test_i8mm_linear_kernel(dev):
    """The i8mm product on the card: M = 4 (the int8 GEMV kernel) and
    M = 256 (torch._int_mm over the same int8 rows) against the plain
    version; both take the same codes and an exact integer product, so the
    outputs agree to one bf16 step."""
    from inferflow_tpu_torch.kernels.decode_step import (i8mm_matmul,
                                                         i8mm_matmul_plain)
    from inferflow_tpu_torch.ops.linear import linear
    from inferflow_tpu_torch.quant.codec_torch import requantize_i8_colwise
    gen = torch.Generator(device=dev).manual_seed(11)
    for k, n in ((2048, 2560), (5632, 2048), (256, 512)):
        w = requantize_i8_colwise(quantize(
            torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5),
            "Q4_B64T1"))
        for m in (4, 256):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            before = _build.launch_counts["i8mm_gemv"]
            got = linear(x, w)
            ref = i8mm_matmul_plain(x, w)
            torch.cuda.synchronize()
            assert _build.launch_counts["i8mm_gemv"] == before + (m <= 8)
            step = torch.finfo(torch.bfloat16).eps * ref.float().abs()
            assert torch.all((got.float() - ref.float()).abs() <= step), (k, m)
            assert torch.equal(i8mm_matmul(x, w), got)


def test_fused_decode_step_kernel(dev):
    """Kernel B4 against its plain version on the same inputs (the plain
    version run on the card too), at test-llama width (3 layers) and at
    tinyllama-1.1b width (2 layers), B = 1 and B = 4 (one slot at length
    0, one at the last cache row).  Tolerance 5e-2 absolute on the hidden
    state (magnitude ~1): the kernel's softmax walk, its sums and its
    rsqrt differ from the plain version's in order and ulps, which can
    move a bf16 rounding and an int8 activation code; the appended rows
    within one Q8 step of the plain version's plus that tolerance."""
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    fused_tol = 5e-2
    for name, layers, s in (("test-llama", 3, 512), ("tinyllama-1.1b", 2, 1024)):
        spec = make_spec(name, layers=layers)
        params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev)
        assert type(params["lm_head"]).__name__ == "Int8MXUTensor"
        hp = spec.hyper_params
        for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
            b = len(lengths)
            cache, gen = _filled_cache(dev, True, layers=layers, b=b,
                                       h=hp.kv_heads, s=s, d=hp.head_dim)
            cache.with_length(torch.tensor(lengths, device=dev))
            twin = dataclasses.replace(
                cache, k=cache.k.clone(), v=cache.v.clone(),
                k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone())
            x = (torch.randn((b, 1, hp.embd_dims), generator=gen, device=dev)
                 * 0.5).to(torch.bfloat16)
            pos = cache.length[:, None]
            before = _build.launch_counts["fused_decode_step"]
            got, _ = fused_decode_step(spec, params["layers"], x, pos, cache)
            ref, _ = fused_decode_step_plain(spec, params["layers"], x, pos,
                                             twin)
            torch.cuda.synchronize()
            assert _build.launch_counts["fused_decode_step"] == before + 1
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= fused_tol, (name, lengths, err)
            for layer in range(layers):
                for a, r in zip(cache.read_layer(layer, torch.float32),
                                twin.read_layer(layer, torch.float32)):
                    for slot, n in enumerate(lengths):
                        row = min(n, s - 1)
                        row_a, row_r = a[slot, row], r[slot, row]
                        step = row_r.abs().amax(dim=-1) / 127.0
                        assert torch.all((row_a - row_r).abs().amax(dim=-1)
                                         <= step + fused_tol), (name, layer)
                    # every other row untouched
                    assert torch.equal(a[0, :min(lengths[0], s - 1)],
                                       r[0, :min(lengths[0], s - 1)])


def test_engine_on_card_matches_cpu(dev):
    """The same test-tiny model served on the card and on the CPU: the
    first greedy tokens agree (random weights: allow a late near-tie)."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions

    spec = make_spec("test-tiny", kv_heads=2, vocab=128,
                     device_layout="packed")
    params = make_synthetic_params(spec, "Q4_B64T1", seed=3, device="cpu")
    outs = []
    for device in ("cpu", "cuda"):
        eng = InferenceEngine(spec, params, max_concurrent_queries=2,
                              max_context_len=128, kv_cache_quantized=True,
                              device=device)
        eng.prefill_chunk = 16
        outs.append(eng.generate(list(np.arange(3, 43) % 128),
                                 SamplingOptions(strategy="greedy"), 6))
    assert outs[0][:3] == outs[1][:3], outs
