"""Kernel B1's Q8 case (launch count ``q8_matmul``) and the fused decode
step's byte mode (c) (``fused_decode_step_byte``) on the card, against
their plain versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_q8.py``.

Tolerances: B1-Q8 and its plain version multiply the same bf16 weights,
bf16(q*sc + base) (the codec's), and sum in float32 in other orders:
|kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps at the largest
output).  B4 (c) and its plain version take the same bf16 weights,
bf16(q * bf16(sc)), and bf16 activations; for one layer the float32 sum
orders (and the batched attention's bf16 roundings of p * vscale relative
to other running maxima) move the hidden state by at most ONE_LAYER_TOL =
3e-2 of max|plain|, as for B4's other modes.  Both kernels give the same
bits on a second launch (their split partials are added in a fixed
order).
"""

import dataclasses

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor, quantize

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
ONE_LAYER_TOL = 3e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _pad_k(qt: QuantizedTensor, k_s: int) -> QuantizedTensor:
    """qt stored with K = k_s: zero-scale (and zero-base) pad blocks whose
    codes are 0x5A (they must add exact zeros whatever they hold)."""
    pad = k_s - qt.storage_k
    plane = torch.nn.functional.pad(qt.planes["data"], (0, 0, 0, pad),
                                    value=0x5A)
    meta = [None if t is None else
            torch.nn.functional.pad(t, (0, 0, 0, pad // 32))
            for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, {"data": plane}, *meta)


def test_q8_matmul_kernel(dev):
    """B1-Q8 in both formats: the decode GEMV (M <= 8) and the tiled kernel
    (M > 8) at llama2-7b's w2 width (K = 11008, also stored K-padded to
    11264) and a small shape; counted launches, the same bits twice."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from inferflow_tpu_torch.ops.linear import linear
    gen = torch.Generator(device=dev).manual_seed(61)
    for fmt in ("Q8_B32T2", "Q8_B32T1"):
        for k, n, k_s in ((96, 512, None), (11008, 4096, None),
                          (11008, 1024, 11264)):
            w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
            qt = quantize(w, fmt)
            qt = qt if k_s is None else _pad_k(qt, k_s)
            for m in list(range(1, 17)) + [256]:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                before = _build.launch_counts["q8_matmul"]
                got = linear(x, qt)
                ref = quantized_matmul_plain(x, qt)
                torch.cuda.synchronize()
                assert _build.launch_counts["q8_matmul"] == before + 1
                assert got.shape == (m, n) and got.dtype == torch.bfloat16
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= REL_TOL * ref.float().abs().max().item() + 1e-6, \
                    (fmt, k, n, k_s, m, err)
                assert torch.equal(quantized_matmul(x, qt), got)


def test_byte_step_one_layer(dev):
    """B4 (c) for one layer of llama2-7b width in both formats, B = 8 and
    B = 1, against its plain version on twin caches: the hidden state, the
    appended K/V rows (within one Q8 step), the same bits twice; the
    step's launch count."""
    from inferflow_tpu_torch.kernels import decode_step
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    for fmt in ("Q8_B32T2", "Q8_B32T1"):
        spec = make_spec("llama2-7b", layers=1)
        params = make_synthetic_params(spec, fmt, seed=0, device=dev)
        hp = spec.hyper_params
        for lengths in ((2047, 700, 301, 17, 0, 1, 64, 1500), (900,)):
            b = len(lengths)
            gen = torch.Generator(device=dev).manual_seed(b)
            cache = KVCache.create(1, b, 2048, hp.kv_heads, hp.head_dim,
                                   quantized=True, device=dev)
            k = torch.randn((b, 2048, hp.kv_heads, hp.head_dim),
                            generator=gen, device=dev)
            cache.update_layer(0, k, -k, torch.zeros(b, dtype=torch.int32,
                                                     device=dev))
            cache.with_length(torch.tensor(lengths, device=dev))
            twin = dataclasses.replace(
                cache, k=cache.k.clone(), v=cache.v.clone(),
                k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone(),
                length=cache.length.clone())
            again = dataclasses.replace(
                cache, k=cache.k.clone(), v=cache.v.clone(),
                k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone(),
                length=cache.length.clone())
            x = torch.randn((b, 1, hp.embd_dims), generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = cache.length[:, None].clone()
            before = _build.launch_counts["fused_decode_step_byte"]
            got, _ = decode_step.fused_decode_step(spec, params["layers"], x,
                                                   pos, cache)
            got2, _ = decode_step.fused_decode_step(spec, params["layers"],
                                                    x, pos, again)
            ref, _ = decode_step.fused_decode_step_plain(
                spec, params["layers"], x, pos, twin)
            torch.cuda.synchronize()
            assert _build.launch_counts["fused_decode_step_byte"] \
                == before + 2
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= ONE_LAYER_TOL * ref.float().abs().max().item(), \
                (fmt, lengths, err)
            assert torch.equal(got, got2)
            for a, r in zip(cache.read_layer(0, torch.float32),
                            twin.read_layer(0, torch.float32)):
                for slot, n in enumerate(lengths):
                    row = min(n, 2047)
                    step = r[slot, row].abs().amax(dim=-1) / 127.0
                    diff = (a[slot, row] - r[slot, row]).abs().amax(dim=-1)
                    assert bool((diff <= step + 1e-6).all()), (fmt, slot)
