"""The i4 layout's kernels on the card: B5 (``i4_matmul``), the i4x8 GEMV
and B4's mode (b), against their plain versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_i4.py``.

Tolerances: B5 and its plain version multiply the same bf16 weights,
bf16(n*sc + (8*sc + base)), and sum in float32 in other orders:
|kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps at the largest
output).  The i4x8 GEMV and its plain version take the same int8 codes and
exact block dots; the block sums of the activations (rounded to bf16) and
the float32 sum over blocks run in other orders: the same 8e-3 *
max|plain|.  B4 (b): 5e-2 absolute on the hidden state (magnitude ~1), as
B4 (a) in tests/test_torch_cuda.py.  Every kernel gives the same bits on
a second run (the i4x8 GEMV adds its float partials in a fixed order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import (QuantizedTensor, quantize,
                                                   repack_i4)

from test_torch_cuda import _filled_cache

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


def _pad_k(qt: QuantizedTensor, k_s: int) -> QuantizedTensor:
    """qt stored with K = k_s: zero-scale, zero-base blocks whose nibbles
    are -8 (the wire code 0), as the JAX zoo pads before it repacks."""
    pad = k_s - qt.storage_k
    plane = torch.nn.functional.pad(qt.planes["data_i4p"], (0, 0, 0, pad // 2),
                                    value=0x88)
    meta = [torch.nn.functional.pad(t, (0, 0, 0, pad // 64))
            for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, {"data_i4p": plane}, *meta)


def _weight(gen, dev, k, n, k_s=None):
    w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
    qt = repack_i4(quantize(w, "Q4_B64T1"))
    return qt if k_s is None else _pad_k(qt, k_s)


def _close(got, ref, tol=REL_TOL):
    err = (got.float() - ref.float()).abs().max().item()
    return err <= tol * ref.float().abs().max().item() + 1e-6


def test_i4_matmul_kernel(dev):
    """B5: the decode GEMV (M <= 8) and the tiled kernel (M > 8, the B > 8
    decode and prefill), a K-padded weight among them."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        i4_matmul_plain, quantized_matmul)
    from inferflow_tpu_torch.ops.linear import linear
    gen = torch.Generator(device=dev).manual_seed(21)
    for k, n, k_s in ((256, 512, None), (2048, 5632, None), (8448, 1024, 8704),
                      (4096, 32000, None)):
        qt = _weight(gen, dev, k, n, k_s)
        for m in (1, 5, 8, 12, 40, 256):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            before = _build.launch_counts["i4_matmul"]
            got = linear(x, qt)
            ref = i4_matmul_plain(x, qt)
            torch.cuda.synchronize()
            assert _build.launch_counts["i4_matmul"] == before + 1
            assert got.shape == (m, n) and got.dtype == torch.bfloat16
            assert _close(got, ref), (k, n, m)
            assert torch.equal(quantized_matmul(x, qt), got)


def test_i4x8_gemv_kernel(dev):
    """The i4x8 GEMV alone (B4 mode (b)'s product) at M in {1, 4, 8},
    against its plain version; equal bits on a second launch."""
    from inferflow_tpu_torch.kernels.decode_step import (i4x8_gemv_cuda,
                                                         i4x8_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(22)
    for k, n, k_s in ((256, 512, None), (4096, 12288, None),
                      (11008, 4096, 11264), (64, 128, None)):
        qt = _weight(gen, dev, k, n, k_s)
        for m in (1, 4, 8):
            x = torch.randn((m, qt.storage_k), generator=gen, device=dev).to(
                torch.bfloat16)
            x[:, k:] = 0
            got = i4x8_gemv_cuda(x, qt)
            ref = i4x8_matmul_plain(x, qt)
            torch.cuda.synchronize()
            assert got.shape == (m, n) and got.dtype == torch.float32
            assert _close(got, ref), (k, n, m)
            assert torch.equal(i4x8_gemv_cuda(x, qt), got)


def _i4_params(dev, name, layers, pad_w2_to=None, **overrides):
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    spec = make_spec(name, layers=layers, device_layout="i4", **overrides)
    params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev)
    if pad_w2_to:
        params["layers"] = [dict(lp, ffn=dict(lp["ffn"], w2=_pad_k(
            lp["ffn"]["w2"], pad_w2_to))) for lp in params["layers"]]
    return spec, params


def test_fused_decode_step_i4_kernel(dev):
    """B4 mode (b) against its plain version on the same inputs: test-llama
    (3 layers, g = 4), llama2-7b width (2 layers, MHA: g = 1, D = 128) and
    a K-padded w2 (inter 8448 stored as 8704); B = 1 and B = 4 (one slot
    at length 0, one at the last cache row).  A second run on a twin
    cache gives the same bits."""
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    for name, layers, s, pad, over in (
            ("test-llama", 3, 512, None, {}),
            ("llama2-7b", 2, 1024, None, {}),
            ("test-llama", 2, 512, 8704, {"inter": 8448})):
        spec, params = _i4_params(dev, name, layers, pad, **over)
        hp = spec.hyper_params
        for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
            b = len(lengths)
            cache, gen = _filled_cache(dev, True, layers=layers, b=b,
                                       h=hp.kv_heads, s=s, d=hp.head_dim)
            cache.with_length(torch.tensor(lengths, device=dev))
            twins = [dataclasses.replace(
                cache, k=cache.k.clone(), v=cache.v.clone(),
                k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone())
                for _ in range(2)]
            x = (torch.randn((b, 1, hp.embd_dims), generator=gen, device=dev)
                 * 0.5).to(torch.bfloat16)
            pos = cache.length[:, None]
            before = _build.launch_counts["fused_decode_step_i4"]
            got, _ = fused_decode_step(spec, params["layers"], x, pos, cache)
            again, _ = fused_decode_step(spec, params["layers"], x, pos,
                                         twins[0])
            ref, _ = fused_decode_step_plain(spec, params["layers"], x, pos,
                                             twins[1])
            torch.cuda.synchronize()
            assert _build.launch_counts["fused_decode_step_i4"] == before + 2
            assert torch.equal(got, again)
            assert torch.equal(cache.k, twins[0].k)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= FUSED_TOL, (name, lengths, err)
            for layer in range(layers):
                for a, r in zip(cache.read_layer(layer, torch.float32),
                                twins[1].read_layer(layer, torch.float32)):
                    for slot, n in enumerate(lengths):
                        row = min(n, s - 1)
                        step = r[slot, row].abs().amax(dim=-1) / 127.0
                        assert torch.all((a[slot, row] - r[slot, row]).abs()
                                         .amax(dim=-1) <= step + FUSED_TOL)


def test_i4_engine_on_card_matches_cpu(dev):
    """test-llama in the i4 layout served on the card and on the CPU, 4
    slots (B4 mode (b) on every decode step) and 9 (the per-layer loop,
    B5 in every product): the first greedy tokens agree and every sampled
    row is within 5e-2."""
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    spec, params = _i4_params("cpu", "test-llama", 3)
    prompt = list(np.arange(3, 83) % spec.hyper_params.vocab_size)
    for slots, kernel in ((4, "fused_decode_step_i4"), (9, "i4_matmul")):
        outs, rows = [], []
        for device in ("cpu", "cuda"):
            eng = InferenceEngine(spec, params, max_concurrent_queries=slots,
                                  max_context_len=256,
                                  kv_cache_quantized=True, device=device)
            eng.prefill_chunk = 32
            seen = []
            choose = eng.strategies.choose_token
            eng.strategies.choose_token = lambda q, r, p=(), c=choose: (
                seen.append(np.asarray(r, np.float32).copy()) or c(q, r, p))
            _build.launch_counts.clear()
            outs.append(eng.generate(prompt, SamplingOptions(
                strategy="greedy"), 6))
            rows.append(seen)
        assert _build.launch_counts[kernel] > 0
        assert _build.launch_counts["dequant_matmul"] == 0
        assert outs[0][:3] == outs[1][:3], outs
        for a, b in zip(*rows):
            if int(a.argmax()) != int(b.argmax()):
                break
            assert np.abs(a - b).max() <= FUSED_TOL
