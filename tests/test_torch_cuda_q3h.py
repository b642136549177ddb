"""Kernel B6 (launch count ``q3h_matmul``: ``quantized_matmul`` on Q3H
weights in the pair8 layout) on the card, against its plain version.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_q3h.py``.

Tolerances: B6 and its plain version multiply the same bf16 weights,
bf16(v*sc + base) with v the base-11 pair value, and sum in float32 in
other orders: |kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps at the
largest output).  The kernel gives the same bits on a second launch (its
split-K partials are added in a fixed order).  The engine on the card
against the same engine on the CPU: 5e-2 on every sampled row while the
argmaxes agree, as for the other layouts.
"""

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor, quantize

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
ENGINE_TOL = 5e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _pad_k(qt: QuantizedTensor, k_s: int) -> QuantizedTensor:
    """qt stored with K = k_s: zero-scale, zero-base pad blocks, their
    bytes set to 0xFF (they must add exact zeros whatever they hold)."""
    pad = k_s - qt.storage_k
    plane = torch.nn.functional.pad(qt.planes["pair8"], (0, 0, 0, pad // 2),
                                    value=0xFF)
    meta = [torch.nn.functional.pad(t, (0, 0, 0, pad // 64))
            for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, {"pair8": plane}, *meta)


def _every_byte(qt: QuantizedTensor) -> QuantizedTensor:
    """qt with its plane holding every byte value 0..255 in turn (bytes
    above 120 are no Q3H code, but kernel and plain version must agree on
    all of them)."""
    plane = torch.arange(qt.planes["pair8"].numel(),
                         device=qt.scale.device) % 256
    plane = plane.to(torch.uint8).reshape(qt.planes["pair8"].shape)
    return QuantizedTensor(qt.format, qt.shape, {"pair8": plane}, qt.scale,
                           qt.base)


def test_q3h_matmul_kernel(dev):
    """B6: the decode GEMV (M <= 8) and the tiled kernel (M > 8), at
    llama2-13b's w2 and lm_head widths, on a K-padded weight and on a plane
    of every byte value; counted launches, the same bits twice."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from inferflow_tpu_torch.ops.linear import linear
    gen = torch.Generator(device=dev).manual_seed(41)
    for k, n, k_s, every in ((256, 512, None, False), (256, 512, None, True),
                             (13824, 5120, None, False),
                             (8256, 1024, 8704, False),
                             (5120, 32000, None, True)):
        w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
        qt = quantize(w, "Q3H_B64T1")
        qt = _every_byte(qt) if every else qt
        qt = qt if k_s is None else _pad_k(qt, k_s)
        for m in (1, 5, 8, 12, 40, 256):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            before = _build.launch_counts["q3h_matmul"]
            got = linear(x, qt)
            ref = quantized_matmul_plain(x, qt)
            torch.cuda.synchronize()
            assert _build.launch_counts["q3h_matmul"] == before + 1
            assert got.shape == (m, n) and got.dtype == torch.bfloat16
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= REL_TOL * ref.float().abs().max().item() + 1e-6, \
                (k, n, m, every, err)
            assert torch.equal(quantized_matmul(x, qt), got)


def test_q3h_engine_on_card_matches_cpu(dev):
    """test-llama in Q3H pair8 served on the card and on the CPU, 4 slots
    and 9: every decode step the per-layer loop with B6 in every product,
    never B1 or the fused step; the first greedy tokens agree and every
    sampled row is within ENGINE_TOL while the argmaxes agree."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    spec = make_spec("test-llama", device_layout="packed")
    params = make_synthetic_params(spec, "Q3H_B64T1", seed=0, device="cpu",
                                   device_layout="packed")
    prompt = list(np.arange(3, 83) % spec.hyper_params.vocab_size)
    for slots in (4, 9):
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
        assert _build.launch_counts["q3h_matmul"] > 0
        for k in ("dequant_matmul", "i4_matmul", "fused_decode_step",
                  "fused_decode_step_i4"):
            assert _build.launch_counts[k] == 0, k
        assert outs[0][:3] == outs[1][:3], outs
        for a, b in zip(*rows):
            if int(a.argmax()) != int(b.argmax()):
                break
            assert np.abs(a - b).max() <= ENGINE_TOL
