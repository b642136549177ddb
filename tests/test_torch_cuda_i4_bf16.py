"""B4's mode (b') on the card: the i4bf16 GEMV alone and the fused step in
that mode, on the i4 layout's four block geometries (Q4_B64T1, Q4_B32T1A/B,
Q4_B32T2, Q4_B16), against their plain versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_i4_bf16.py``.

Tolerances: the GEMV multiplies the same bf16 activations by the same
bf16 weights bf16(bf16(n) * bf16(sc)) as its plain version and adds the
same bf16 block folds; only float32 summation orders differ:
|kernel - plain| <= 8e-3 * max|plain|, as for the other GEMVs.  The step:
5e-2 of the hidden state's scale max(1, max|plain|) plus one bf16 step of
each element, as tests/test_torch_cuda_i4_formats.py holds mode (b) at
magnitude ~1 (the residual is rounded to bf16 after every product); the
scale term is for Q4_B32T2, whose coarse u8-coded metadata grows two
random llama2-7b layers' residual to max|plain| = 48 (Q4_B32T1A: 2.4,
Q4_B16: 10.5; the plain step on the CPU); a MoE layer with i4
experts in mode (g): within 3e-2 of max|plain| where every route agrees,
as tests/test_torch_cuda_moe.py holds it.  Every kernel gives the same bits
on a second run; each geometry launches its own instantiation (its launch
count), and no i4x8 one launches.
"""

import dataclasses

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import quantize, repack_i4

from test_torch_cuda import _filled_cache
from test_torch_cuda_moe import ONE_LAYER_TOL, _one_layer

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
FUSED_TOL = 5e-2
# format -> (GEMV launch count, step launch count)
FORMATS = {"Q4_B64T1": ("i4bf16_gemv", "fused_decode_step_i4bf16"),
           "Q4_B32T1A": ("i4bf16_gemv_b32", "fused_decode_step_i4bf16_b32"),
           "Q4_B32T1B": ("i4bf16_gemv_b32", "fused_decode_step_i4bf16_b32"),
           "Q4_B32T2": ("i4bf16_gemv_b32f", "fused_decode_step_i4bf16_b32f"),
           "Q4_B16": ("i4bf16_gemv_b16f", "fused_decode_step_i4bf16_b16f")}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _close(got, ref, tol=REL_TOL):
    err = (got.float() - ref.float()).abs().max().item()
    return err <= tol * ref.float().abs().max().item() + 1e-6


def test_i4bf16_gemv_kernel(dev):
    """The (b') GEMV alone (the tensor-core walk) on each format, at test
    and llama2-7b shapes, M in {1, 5, 8}; at the edges its tiling brings,
    every M in 1..8: N = 100 and 36 (multiples of 4, not of 16: 4- and
    8-byte copies, a ragged tile), K of one quant block, and K = 1088 at N
    = 4096, whose K splits end in a short one (on 132 SMs, 8 of 128 rows
    and one of 64)."""
    from inferflow_tpu_torch.kernels.decode_step import (
        _gemv_splits, _i4_geometry, _sms, i4_bf16_matmul_plain,
        i4bf16_gemv_cuda)
    from inferflow_tpu_torch.quant.formats import get_format
    gen = torch.Generator(device=dev).manual_seed(51)
    for fmt, (gemv, _) in FORMATS.items():
        blk = get_format(fmt).block
        shapes = [((256, 512), (1, 5, 8)), ((4096, 12288), (1, 5, 8)),
                  ((11008, 4096), (1, 5, 8)), ((128, 128), (1, 5, 8)),
                  ((256, 100), range(1, 9)), ((blk, 36), range(1, 9)),
                  ((1088, 4096), range(1, 9))]
        for (k, n), ms in shapes:
            w = torch.randn((k, n), generator=gen, device=dev) * (
                0.5 / k ** 0.5)
            qt = repack_i4(quantize(w, fmt))
            if k == 1088:  # several K splits
                code = _i4_geometry(qt, "i4bf16")[0]
                assert _gemv_splits(k, n, False, _sms(w), code) > 1
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                _build.launch_counts.clear()
                got = i4bf16_gemv_cuda(x, qt)
                ref = i4_bf16_matmul_plain(x, qt)
                torch.cuda.synchronize()
                assert dict(_build.launch_counts) == {gemv: 1}
                assert _close(got, ref), (fmt, k, n, m)
                assert torch.equal(i4bf16_gemv_cuda(x, qt), got)


def test_fused_decode_step_i4bf16(dev, monkeypatch):
    """B4 mode (b') against its plain version on every geometry (the GLU's
    a and g segments in one CTA): test-llama (3 layers) and llama2-7b width
    (2 layers), B = 1 and B = 4; then the same weights with
    INFERFLOW_I4_DOT=i8 in the same process take mode (b) (the
    pointer-table cache keys on the mode)."""
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    for fmt in ("Q4_B64T1", "Q4_B32T1A", "Q4_B32T2", "Q4_B16"):
        counter = FORMATS[fmt][1]
        for name, layers, s in (("test-llama", 3, 512),
                                ("llama2-7b", 2, 1024)):
            spec = make_spec(name, layers=layers, device_layout="i4")
            params = make_synthetic_params(spec, fmt, seed=0, device=dev,
                                           device_layout="i4")
            hp = spec.hyper_params
            for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
                monkeypatch.setenv("INFERFLOW_I4_DOT", "bf16")
                b = len(lengths)
                cache, gen = _filled_cache(dev, True, layers=layers, b=b,
                                           h=hp.kv_heads, s=s, d=hp.head_dim)
                cache.with_length(torch.tensor(lengths, device=dev))
                twins = [dataclasses.replace(
                    cache, k=cache.k.clone(), v=cache.v.clone(),
                    k_scale=cache.k_scale.clone(),
                    v_scale=cache.v_scale.clone()) for _ in range(3)]
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
                assert dict(_build.launch_counts) == {counter: 2}
                assert torch.equal(got, again)
                ref = ref.float()
                step = torch.exp2(torch.floor(torch.log2(ref.abs() + 1e-30))
                                  - 7)
                err = (got.float() - ref).abs()
                scale = max(1.0, ref.abs().max().item())
                assert bool((err <= FUSED_TOL * scale + step).all()), (
                    fmt, name, lengths, err.max().item())
                monkeypatch.setenv("INFERFLOW_I4_DOT", "i8")
                _build.launch_counts.clear()
                fused_decode_step(spec, params["layers"], x, pos, twins[2])
                assert dict(_build.launch_counts) == {
                    counter.replace("i4bf16", "i4"): 1}
            del params
            torch.cuda.empty_cache()


def test_moe_step_with_i4bf16_experts(dev, monkeypatch):
    """B4 (g) with i4 experts in mode (b'), layer by layer against its
    plain version: the wide test-moe (E = 128, 4 experts, top-2) at B in
    {1, 2, 8}."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    monkeypatch.setenv("INFERFLOW_I4_DOT", "bf16")
    spec = make_spec("test-moe", device_layout="i4", embd=128, inter=256)
    params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev,
                                   device_layout="i4")
    for lengths in ([9], [4, 21], [3, 9, 4, 2, 6, 0, 11, 5]):
        worst, agree, same = _one_layer(spec, params["layers"], lengths, dev,
                                        seed=len(lengths))
        assert worst <= ONE_LAYER_TOL, (lengths, worst)
        assert agree > 0.5 and same, (lengths, agree)
