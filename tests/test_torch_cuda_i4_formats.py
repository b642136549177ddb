"""The i4 layout's kernels on the card for the 4-bit formats beside
Q4_B64T1: B5 and the i4x8 GEMV on Q4_B32T1A, Q4_B32T1B, Q4_B32T2 and
Q4_B16, and B4's mode (b) on Q4_B32T1A and Q4_B16, against their plain
versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_i4_formats.py``.

Tolerances, as tests/test_torch_cuda_i4.py states them for Q4_B64T1: B5
and its plain version multiply the same bf16 weights and sum in float32 in
other orders, |kernel - plain| <= 8e-3 * max|plain|; the i4x8 GEMV takes
the same int8 codes and exact block dots as its plain version, and only
the float32 sums over blocks and the bf16 block sums of the activations
run in other orders: the same 8e-3 * max|plain|; B4 (b): 5e-2 absolute on
the hidden state (magnitude ~1, as tests/test_torch_cuda_i4.py) plus one
bf16 step of each element: the residual is rounded to bf16 after every
product, and a float32 sum that ends on the other side of a rounding
boundary moves an element by one step, 0.0625 for the elements of 8 to 16
that llama2-7b's residual reaches (measured once on Q4_B16 at B = 4).
Every kernel gives the same bits on a second run.  Each format launches its own instantiation (its launch
count), and the Q4_B64T1 one does not launch.

The codec runs on the card where the loader quantizes: its bytes there
equal its bytes on the CPU (which equal the JAX codec's), exactly.
"""

import dataclasses

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import quantize, repack_i4

from test_torch_cuda import _filled_cache

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
FUSED_TOL = 5e-2
# format -> (B5 launch count, i4x8 GEMV launch count)
FORMATS = {"Q4_B32T1A": ("i4_matmul_b32", "i4x8_gemv_b32"),
           "Q4_B32T1B": ("i4_matmul_b32", "i4x8_gemv_b32"),
           "Q4_B32T2": ("i4_matmul_b32f", "i4x8_gemv_b32f"),
           "Q4_B16": ("i4_matmul_b16f", "i4x8_gemv_b16f")}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _weight(gen, dev, k, n, fmt):
    w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
    return repack_i4(quantize(w, fmt))


def _close(got, ref, tol=REL_TOL):
    err = (got.float() - ref.float()).abs().max().item()
    return err <= tol * ref.float().abs().max().item() + 1e-6


def test_b5_and_i4x8_gemv_kernels(dev):
    """B5 (M <= 8 the GEMV, more rows the tiled kernel) and the i4x8 GEMV
    alone on each format, at test and llama2-7b shapes."""
    from inferflow_tpu_torch.kernels.decode_step import (i4x8_gemv_cuda,
                                                         i4x8_matmul_plain)
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        i4_matmul_plain, quantized_matmul)
    gen = torch.Generator(device=dev).manual_seed(31)
    for fmt, (b5, gemv) in FORMATS.items():
        for k, n in ((256, 512), (4096, 12288), (11008, 4096), (96, 128)):
            qt = _weight(gen, dev, k, n, fmt)
            for m in (1, 5, 8, 12, 256):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                _build.launch_counts.clear()
                got = quantized_matmul(x, qt)
                ref = i4_matmul_plain(x, qt)
                torch.cuda.synchronize()
                assert _build.launch_counts[b5] == 1
                assert _build.launch_counts["i4_matmul"] == 0
                assert _close(got, ref), (fmt, k, n, m)
                assert torch.equal(quantized_matmul(x, qt), got)
                if m > 8:
                    continue
                got = i4x8_gemv_cuda(x, qt)
                ref = i4x8_matmul_plain(x, qt)
                torch.cuda.synchronize()
                assert _build.launch_counts[gemv] == 1
                assert _close(got, ref), (fmt, k, n, m)
                assert torch.equal(i4x8_gemv_cuda(x, qt), got)


def test_fused_decode_step_i4_formats(dev):
    """B4 mode (b) on Q4_B32T1A and Q4_B16 against its plain version:
    test-llama (3 layers) and llama2-7b width (2 layers), B = 1 and B = 4;
    a second run on a twin cache gives the same bits."""
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    for fmt, counter in (("Q4_B32T1A", "fused_decode_step_i4_b32"),
                         ("Q4_B16", "fused_decode_step_i4_b16f")):
        for name, layers, s in (("test-llama", 3, 512), ("llama2-7b", 2, 1024)):
            spec = make_spec(name, layers=layers, device_layout="i4")
            params = make_synthetic_params(spec, fmt, seed=0, device=dev,
                                           device_layout="i4")
            hp = spec.hyper_params
            for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
                b = len(lengths)
                cache, gen = _filled_cache(dev, True, layers=layers, b=b,
                                           h=hp.kv_heads, s=s, d=hp.head_dim)
                cache.with_length(torch.tensor(lengths, device=dev))
                twins = [dataclasses.replace(
                    cache, k=cache.k.clone(), v=cache.v.clone(),
                    k_scale=cache.k_scale.clone(),
                    v_scale=cache.v_scale.clone()) for _ in range(2)]
                x = (torch.randn((b, 1, hp.embd_dims), generator=gen,
                                 device=dev) * 0.5).to(torch.bfloat16)
                pos = cache.length[:, None]
                _build.launch_counts.clear()
                got, _ = fused_decode_step(spec, params["layers"], x, pos,
                                           cache)
                again, _ = fused_decode_step(spec, params["layers"], x, pos,
                                             twins[0])
                ref, _ = fused_decode_step_plain(spec, params["layers"], x,
                                                 pos, twins[1])
                torch.cuda.synchronize()
                assert _build.launch_counts[counter] == 2
                assert _build.launch_counts["fused_decode_step_i4"] == 0
                assert torch.equal(got, again)
                ref = ref.float()
                step = torch.exp2(torch.floor(torch.log2(ref.abs() + 1e-30))
                                  - 7)
                err = (got.float() - ref).abs()
                assert bool((err <= FUSED_TOL + step).all()), (
                    fmt, name, lengths, err.max().item())


def test_codec_on_card_matches_cpu(dev):
    """quantize (every block format), the KV codec, the i8mm container and
    the int8 row activations give the same bytes on the card as on the
    CPU: every division by a constant is a true division on both."""
    from inferflow_tpu_torch.quant import codec_torch
    from inferflow_tpu_torch.quant.formats import FORMATS
    gen = torch.Generator().manual_seed(41)
    for fmt in sorted(FORMATS):
        scale = 0.25 if FORMATS[fmt].meta == "u8" else 1.0
        x = (torch.randn((512, 384), generator=gen) * scale).to(
            torch.float16).float()
        got, ref = quantize(x.to(dev), fmt), quantize(x, fmt)
        for name in ref.planes:
            assert torch.equal(got.planes[name].cpu(), ref.planes[name]), fmt
        assert torch.equal(got.scale.cpu(), ref.scale), fmt
        assert (got.base is None) == (ref.base is None), fmt
        if ref.base is not None:
            assert torch.equal(got.base.cpu(), ref.base), fmt
    x = torch.randn((4, 64, 8, 128), generator=gen)
    for a, b in zip(codec_torch.quantize_q8_sym(x.to(dev)),
                    codec_torch.quantize_q8_sym(x)):
        assert torch.equal(a.cpu(), b)
    w = torch.randn((512, 384), generator=gen)
    a, b = (codec_torch.requantize_i8_colwise(w.to(dev)),
            codec_torch.requantize_i8_colwise(w))
    assert torch.equal(a.data.cpu(), b.data) and torch.equal(a.scale.cpu(),
                                                             b.scale)
    for a, b in zip(codec_torch.int8_rowwise_activations(w.to(dev)),
                    codec_torch.int8_rowwise_activations(w)):
        assert torch.equal(a.cpu(), b)
