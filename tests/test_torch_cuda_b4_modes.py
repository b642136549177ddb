"""B4's wire mode, mode (c) (Q8 byte codes), mode (h) (Q3H pair8), mode
(d) (per-product output biases) and mode (b)'s i4x8 GEMV on the int8
tensor cores (2..8 rows; one row on the dp4a loop) on the card, against
their plain versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_b4_modes.py``.

Tolerances: the GEMVs multiply the same bf16 activations by the same bf16
weights bf16(q * bf16(sc)) as their plain versions and add the same bf16
block base terms; only float32 summation orders differ: |kernel - plain|
<= 8e-3 * max|plain|, as for the other GEMVs.  The step: 5e-2 of the
hidden state's scale max(1, max|plain|) plus one bf16 step of each
element, as tests/test_torch_cuda_i4_bf16.py holds its modes (the
residual is rounded to bf16 after every product); a MoE layer in mode (g)
within tests/test_torch_cuda_moe.py's ONE_LAYER_TOL of max|plain| where
every route agrees.  Every kernel gives the same bits on a second run,
and each geometry launches its own instantiation (its launch count).  The
i4x8 GEMV: its int8 row codes and int32 block dots are the plain
version's, its float32 sums in another order: the same 8e-3; and rows of
the walk equal the dp4a loop's one-row result bit for bit where both
plans take one K split (K 1024, 2 x SMs column tiles).
"""

import dataclasses

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import quantize

from test_torch_cuda import _filled_cache
from test_torch_cuda_moe import ONE_LAYER_TOL, _one_layer

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
FUSED_TOL = 5e-2
# the i4 layout's geometries in mode (b): format -> GEMV launch count
I4X8 = {"Q4_B64T1": "i4x8_gemv", "Q4_B32T1A": "i4x8_gemv_b32",
        "Q4_B32T2": "i4x8_gemv_b32f", "Q4_B16": "i4x8_gemv_b16f"}
# format -> (GEMV launch count, step launch count)
FORMATS = {"Q4_B64T1": ("wire_gemv", "fused_decode_step_wire"),
           "Q4_B32T1A": ("wire_gemv_b32", "fused_decode_step_wire_b32"),
           "Q4_B32T1B": ("wire_gemv_b32", "fused_decode_step_wire_b32"),
           "Q2_B32T1A": ("wire_gemv_q2", "fused_decode_step_wire_q2"),
           "Q2_B32T1B": ("wire_gemv_q2", "fused_decode_step_wire_q2"),
           "Q3H_B64T1": ("pair8_gemv", "fused_decode_step_pair8"),
           "Q8_B32T2": ("byte_gemv", "fused_decode_step_byte"),
           "Q8_B32T1": ("byte_gemv", "fused_decode_step_byte")}


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


def test_code_gemvs(dev):
    """The wire and pair8 GEMVs (on the tensor-core walk), the byte GEMV
    and mode (b)'s i4x8 GEMV (the i4 layout's four geometries) alone on
    each format, at test and llama2 shapes and at N = 100 and 1000 (a
    ragged last column tile; rows 4 and 8 bytes aligned: the walk's copies
    take piece_of's 4- and 8-byte pieces), M = 1..8, the same bits on a
    second run; then the i4x8 walk's rows against the dp4a loop's one-row
    GEMV, bit for bit, where both take one K split."""
    from inferflow_tpu_torch.kernels.decode_step import (
        _product_f32, byte_gemv_cuda, i4x8_gemv_cuda, i4x8_matmul_plain,
        pair8_gemv_cuda, wire_gemv_cuda)
    from inferflow_tpu_torch.quant.codec_torch import repack_i4
    launches = {"pair8_gemv": pair8_gemv_cuda, "byte_gemv": byte_gemv_cuda}
    gen = torch.Generator(device=dev).manual_seed(52)
    cases = [(fmt, gemv, launches.get(gemv, wire_gemv_cuda), _product_f32, False)
             for fmt, (gemv, _) in FORMATS.items()]
    cases += [(fmt, gemv, i4x8_gemv_cuda, i4x8_matmul_plain, True)
              for fmt, gemv in I4X8.items()]
    for fmt, gemv, launch, plain, i4 in cases:
        for k, n in ((256, 512), (4096, 12288), (11008, 4096), (128, 128),
                     (256, 100), (512, 1000)):
            w = torch.randn((k, n), generator=gen, device=dev) * (
                0.5 / k ** 0.5)
            qt = quantize(w, fmt)
            if i4:
                qt = repack_i4(qt)
            for m in range(1, 9):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                _build.launch_counts.clear()
                got = launch(x, qt)
                ref = plain(x, qt)
                torch.cuda.synchronize()
                assert dict(_build.launch_counts) == {gemv: 1}
                assert _close(got, ref), (fmt, k, n, m)
                assert torch.equal(launch(x, qt), got)
    # one K split in both plans: K <= 1024 and a column tile for each of
    # the two CTAs an SM
    n = 2 * torch.cuda.get_device_properties(dev).multi_processor_count * 128
    for fmt in I4X8:
        qt = repack_i4(quantize(torch.randn((1024, n), generator=gen, device=dev)
                                * (0.5 / 32), fmt))
        x = torch.randn((8, 1024), generator=gen, device=dev).to(torch.bfloat16)
        walk = i4x8_gemv_cuda(x, qt)
        for m in range(8):
            assert torch.equal(walk[m:m + 1], i4x8_gemv_cuda(x[m:m + 1], qt)), (
                fmt, m)


def test_walk_gemv_reads_rewritten_weights(dev):
    """A walk GEMV starts to stream its weights before the launch ahead of
    it on the stream has finished (programmatic dependent launch): a
    weight rewritten in place by PyTorch's copies right between two GEMVs,
    with no synchronization, is read as rewritten, bit for bit as a GEMV
    on a fresh copy of the new weight."""
    from inferflow_tpu_torch.kernels.decode_step import (
        _product_f32, i4x8_gemv_cuda, i4x8_matmul_plain, pair8_gemv_cuda,
        wire_gemv_cuda)
    from inferflow_tpu_torch.quant.codec_torch import repack_i4
    gen = torch.Generator(device=dev).manual_seed(53)
    k, n = 4096, 12288
    for fmt, launch in (("Q4_B64T1", wire_gemv_cuda),
                        ("Q3H_B64T1", pair8_gemv_cuda),
                        ("Q4_B32T1A", i4x8_gemv_cuda)):
        i4 = launch is i4x8_gemv_cuda
        old, new = ((repack_i4 if i4 else lambda q: q)(
            quantize(torch.randn((k, n), generator=gen, device=dev)
                     * (0.5 / k ** 0.5), fmt)) for _ in range(2))
        live = dataclasses.replace(
            old, planes={p: t.clone() for p, t in old.planes.items()},
            scale=old.scale.clone(),
            base=None if old.base is None else old.base.clone())
        x = torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
        before = launch(x, live)
        for p, t in live.planes.items():
            t.copy_(new.planes[p])
        live.scale.copy_(new.scale)
        if live.base is not None:
            live.base.copy_(new.base)
        after = launch(x, live)
        fresh = launch(x, new)
        torch.cuda.synchronize()
        assert torch.equal(before, launch(x, old)), fmt
        assert torch.equal(after, fresh), fmt
        assert _close(after, (i4x8_matmul_plain if i4 else _product_f32)(
            x, new)), fmt


def _biases(spec, layers, gen, dev):
    """Seeded float32 output biases (scale 0.05) on all four products of
    every layer, as new layer dicts over the same weights."""
    out = []
    for lp in layers:
        attn, ffn = dict(lp["attn"]), dict(lp["ffn"])
        for grp in (attn, ffn):
            for name in [k for k in ("qkv", "wo", "w1n3", "w2") if k in grp]:
                n = int(grp[name].shape[-1])
                grp[f"{name}_b"] = torch.randn(
                    (n,), generator=gen, device=dev) * 0.05
        out.append(dict(lp, attn=attn, ffn=ffn))
    return out


def _step_vs_plain(spec, layers, lengths, dev, s, counter):
    """The fused step twice and its plain version once on the same cache
    contents: the launch counts, the same bits twice and the tolerance."""
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    hp = spec.hyper_params
    b = len(lengths)
    cache, gen = _filled_cache(dev, True, layers=len(layers), b=b,
                               h=hp.kv_heads, s=s, d=hp.head_dim)
    cache.with_length(torch.tensor(lengths, device=dev))
    twins = [dataclasses.replace(
        cache, k=cache.k.clone(), v=cache.v.clone(),
        k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone())
        for _ in range(2)]
    x = (torch.randn((b, 1, hp.embd_dims), generator=gen, device=dev)
         * 0.5).to(torch.bfloat16)
    pos = cache.length[:, None]
    _build.launch_counts.clear()
    got, _ = fused_decode_step(spec, layers, x, pos, cache)
    again, _ = fused_decode_step(spec, layers, x, pos, twins[0])
    ref, _ = fused_decode_step_plain(spec, layers, x, pos, twins[1])
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == counter
    assert torch.equal(got, again)
    ref = ref.float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs() + 1e-30)) - 7)
    err = (got.float() - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    assert bool((err <= FUSED_TOL * scale + step).all()), (
        lengths, err.max().item())


def test_fused_step_wire_and_pair8(dev):
    """B4 in the wire mode, mode (h) and mode (c) against its plain version
    on every geometry: test-llama (3 layers) and llama2-7b width (2
    layers), B = 1 and B = 4."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    for fmt in ("Q4_B64T1", "Q4_B32T1A", "Q2_B32T1A", "Q3H_B64T1", "Q8_B32T2",
                "Q8_B32T1"):
        counter = FORMATS[fmt][1]
        for name, layers, s in (("test-llama", 3, 512),
                                ("llama2-7b", 2, 1024)):
            spec = make_spec(name, layers=layers, device_layout="packed")
            params = make_synthetic_params(spec, fmt, seed=0, device=dev,
                                           device_layout="packed")
            for lengths in ([s // 2 + 3], [s - 1, 0, 300, 17]):
                _step_vs_plain(spec, params["layers"], lengths, dev, s,
                               {counter: 2})
            del params
            torch.cuda.empty_cache()


def test_fused_step_biases(dev):
    """Mode (d): biases on all four products in every weight mode (i8mm,
    i4x8, byte, the three wire geometries, pair8) at test-llama, B = 1 and
    4, each step counted under its mode and under fused_decode_step_bias;
    a bias of the wrong length raises."""
    from inferflow_tpu_torch.kernels.decode_step import fused_decode_step
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    gen = torch.Generator(device=dev).manual_seed(53)
    for fmt, layout, counter in (
            ("Q4_B64T1", "i8mm", "fused_decode_step"),
            ("Q4_B64T1", "i4", "fused_decode_step_i4"),
            ("Q8_B32T2", "packed", "fused_decode_step_byte"),
            ("Q4_B64T1", "packed", "fused_decode_step_wire"),
            ("Q4_B32T1A", "packed", "fused_decode_step_wire_b32"),
            ("Q2_B32T1A", "packed", "fused_decode_step_wire_q2"),
            ("Q3H_B64T1", "packed", "fused_decode_step_pair8")):
        spec = make_spec("test-llama", device_layout=layout)
        params = make_synthetic_params(spec, fmt, seed=0, device=dev,
                                       device_layout=layout)
        layers = _biases(spec, params["layers"], gen, dev)
        for lengths in ([259], [511, 0, 300, 17]):
            _step_vs_plain(spec, layers, lengths, dev, 512,
                           {counter: 2, "fused_decode_step_bias": 2})
    hp = spec.hyper_params
    bad = [dict(lp, attn=dict(lp["attn"], wo_b=lp["attn"]["wo_b"][:-4]))
           for lp in layers]
    cache, _ = _filled_cache(dev, True, layers=len(bad), b=1,
                             h=hp.kv_heads, s=512, d=hp.head_dim)
    x = torch.zeros((1, 1, hp.embd_dims), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="wo_b"):
        fused_decode_step(spec, bad, x, cache.length[:, None], cache)


def test_paged_and_moe_modes(dev, monkeypatch):
    """The new modes under mode (f) (a paged pool, wire weights with
    biases) and mode (g) (test-moe with wire, pair8 and Q8_B32T1 byte
    experts, one layer at a time against the plain stack's input)."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache
    from inferflow_tpu_torch.kernels.decode_step import (
        fused_decode_step, fused_decode_step_plain)
    gen = torch.Generator(device=dev).manual_seed(54)
    spec = make_spec("test-llama", device_layout="packed")
    params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev,
                                   device_layout="packed")
    layers = _biases(spec, params["layers"], gen, dev)
    hp = spec.hyper_params
    pools = [PagedKVCache.create(hp.decoder_layers, 2, 1024, hp.kv_heads,
                                 hp.head_dim, pool_tokens=4096,
                                 quantized=True, device=dev)
             for _ in range(2)]
    for pool in pools:
        pool.with_page_row(0, [3, 1])
        pool.with_page_row(1, [2, 5])
        pool.with_length(torch.tensor([130, 7], device=dev))
    x = (torch.randn((2, 1, hp.embd_dims), generator=gen, device=dev)
         * 0.5).to(torch.bfloat16)
    pos = pools[0].length[:, None]
    _build.launch_counts.clear()
    got, _ = fused_decode_step(spec, layers, x, pos, pools[0])
    ref, _ = fused_decode_step_plain(spec, layers, x, pos, pools[1])
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"fused_decode_step_wire": 1,
                                          "fused_decode_step_bias": 1}
    assert _close(got, ref, FUSED_TOL)
    monkeypatch.setenv("INFERFLOW_MEGA", "2")
    for fmt in ("Q4_B64T1", "Q3H_B64T1", "Q8_B32T1"):
        moe = make_spec("test-moe", device_layout="packed", embd=128,
                        inter=256)
        mp = make_synthetic_params(moe, fmt, seed=0, device=dev,
                                   device_layout="packed")
        for lengths in ([9], [4, 21], [3, 9, 4, 2, 6, 0, 11, 5]):
            worst, agree, same = _one_layer(moe, mp["layers"], lengths, dev,
                                            seed=len(lengths))
            assert worst <= ONE_LAYER_TOL, (fmt, lengths, worst)
            assert agree > 0.5 and same, (fmt, lengths, agree)


def test_launch_failure_raises(dev, monkeypatch):
    """A launch the kernel refuses raises (no fallback to the plain
    version): the wire GEMV asked for a mode it does not take, and a
    build that fails raises before any launch."""
    from inferflow_tpu_torch.kernels import decode_step as ds
    qt = quantize(torch.randn((256, 128), device=dev), "Q4_B64T1")
    x = torch.randn((2, 256), device=dev).to(torch.bfloat16)
    real = ds._code_geometry
    monkeypatch.setattr(ds, "_code_geometry",
                        lambda w: (99,) + real(w)[1:])
    monkeypatch.setattr(ds, "_gemv_splits", lambda *a: 1)
    with pytest.raises(RuntimeError, match="wire_gemv: CUDA error"):
        ds.wire_gemv_cuda(x, qt)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("--no-such-nvcc-option",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ds.wire_gemv_cuda(x, qt)
