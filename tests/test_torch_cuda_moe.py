"""Kernel B4's routed-expert mode (g) (launch count
``fused_decode_step_moe``) and its routing launch (``moe_route``) on the
card, against their plain versions.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_moe.py``.

Tolerances and grounds:
  - the routing: the kernel's xn within one bf16 step of the plain
    rmsnorm (the norm's float32 sum order differs); the chosen experts
    equal wherever the plain version's k-th and (k+1)-th probabilities
    differ by more than GAP_EPS = 1e-4 (a float32 gate dot in another sum
    order moves a probability by ~1e-7; 1e-4 leaves three orders of
    magnitude); their weights within 1e-5 (float32 softmax);
  - one layer of the step (one residual rounding per expert, the products
    in float32 in other orders): the hidden state within ONE_LAYER_TOL =
    3e-2 of max|plain|, as for B4's other modes, where every route agrees;
    the same bits on a second launch.
"""

import dataclasses

import pytest
import torch

from inferflow_tpu_torch.kernels import _build

pytestmark = pytest.mark.cuda
GAP_EPS = 1e-4
ONE_LAYER_TOL = 3e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _clear_gaps(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(..., n_exp) -> (...,) whether every one of the top_k choices is
    separated from the next probability by more than GAP_EPS."""
    s = torch.sort(probs, dim=-1, descending=True).values
    return ((s[..., :top_k] - s[..., 1:top_k + 1]) > GAP_EPS).all(dim=-1)


def test_moe_route_kernel(dev):
    """The routing launch at test width (E = 128, 4 experts, top-2) and
    mixtral width (E = 4096, 8 experts), B in {1, 2, 8}, with and without
    norm_topk; ties go to the lower expert."""
    from inferflow_tpu_torch.kernels import decode_step as ds
    gen = torch.Generator(device=dev).manual_seed(5)
    for e, n_exp, top_k in ((128, 4, 2), (4096, 8, 2), (4096, 8, 4)):
        gate = (torch.randn((e, n_exp), generator=gen, device=dev)
                * e ** -0.5).to(torch.bfloat16)
        norm_w = (1 + 0.1 * torch.randn((e,), generator=gen, device=dev)
                  ).to(torch.bfloat16)
        for b in (1, 2, 8):
            x = torch.randn((b, e), generator=gen, device=dev).to(
                torch.bfloat16)
            for norm in (True, False):
                _build.launch_counts.clear()
                xn, sel, w = ds.moe_route(x, norm_w, gate, top_k, norm, 1e-5)
                assert _build.launch_counts[ds.ROUTE_KERNEL] == 1
                ref_xn = ds._rmsnorm(x, norm_w, 1e-5)
                step = ref_xn.float().abs() * 2.0 ** -7 + 1e-30
                assert ((xn.float() - ref_xn.float()).abs() <= step).all()
                ref_sel, ref_w = ds.moe_route_plain(xn, gate, top_k, norm)
                probs = torch.softmax(xn.float() @ gate.float(), dim=-1)
                clear = _clear_gaps(probs, top_k)
                assert torch.equal(sel[clear], ref_sel[clear])
                torch.testing.assert_close(w[clear], ref_w[clear],
                                           rtol=1e-5, atol=1e-6)
    # ties: experts 1 and 3 copy experts 0 and 2
    gate = gate[:, :4].clone()
    gate[:, 1], gate[:, 3] = gate[:, 0], gate[:, 2]
    x = torch.randn((8, 4096), generator=gen, device=dev).to(torch.bfloat16)
    xn, sel, _ = ds.moe_route(x, norm_w, gate.contiguous(), 2, True, 1e-5)
    assert torch.equal(sel[:, 1], sel[:, 0] + 1)
    assert (sel[:, 0] % 2 == 0).all()


def _one_layer(spec, layers, lengths, dev, seed):
    """Each layer of `layers` alone on the card and in its plain version,
    fed the plain stack's input to that layer: (worst error over max|plain|
    where every route agrees, share of route decisions that agree, same
    bits twice)."""
    from inferflow_tpu_torch.kernels import decode_step as ds
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    hp = spec.hyper_params
    b = len(lengths)
    cache = KVCache.create(hp.decoder_layers, b, 512, hp.kv_heads,
                           hp.head_dim, quantized=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = max(lengths)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    for layer in range(hp.decoder_layers):
        k, v = (torch.randn((b, rows, hp.kv_heads, hp.head_dim),
                            generator=gen, device=dev) for _ in range(2))
        cache.update_layer(layer, k, v, zeros)
    cache.with_length(torch.tensor(lengths, dtype=torch.int32, device=dev))
    x = (torch.randn((b, 1, hp.embd_dims), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    pos = cache.length[:, None].clone()
    twin = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                               k_scale=cache.k_scale.clone(),
                               v_scale=cache.v_scale.clone())
    plain = []
    ds.fused_decode_step_plain(spec, layers, x, pos, twin, routes=plain)
    plain = plain[0]
    worst, agree, total, same = 0.0, 0, 0, True
    for layer in range(len(layers)):
        one = dataclasses.replace(
            cache, k=cache.k[layer:layer + 1], v=cache.v[layer:layer + 1],
            k_scale=cache.k_scale[layer:layer + 1],
            v_scale=cache.v_scale[layer:layer + 1])
        xin = plain["inputs"][layer][:, None]
        ref, _ = ds.fused_decode_step_plain(
            spec, layers[layer:layer + 1], xin, pos,
            dataclasses.replace(one, k=one.k.clone(), v=one.v.clone(),
                                k_scale=one.k_scale.clone(),
                                v_scale=one.v_scale.clone()))
        routes = []
        _build.launch_counts.clear()
        got, _ = ds.fused_decode_step(spec, layers[layer:layer + 1], xin,
                                      pos, one, routes=routes)
        again, _ = ds.fused_decode_step(spec, layers[layer:layer + 1], xin,
                                        pos, one)
        assert _build.launch_counts[ds.MOE_KERNEL] == 2
        same &= bool(torch.equal(got, again))
        sel = routes[0]["experts"][0]
        ref_sel = plain["experts"][layer]
        agree += int((sel == ref_sel).all(dim=-1).sum())
        total += b
        clear = _clear_gaps(plain["probs"][layer], sel.shape[-1])
        assert torch.equal(sel[clear], ref_sel[clear]), layer
        ok = (sel == ref_sel).all(dim=-1)
        if ok.any():
            err = (got[ok].float() - ref[ok].float()).abs().max().item()
            worst = max(worst, err / ref[ok].float().abs().max().item())
    return worst, agree / total, same


def test_fused_moe_step_kernel(dev):
    """B4 (g) layer by layer against its plain version: the wide test-moe
    (E = 128, 4 experts, top-2) with i8mm, Q8_B32T2 and i4 experts at B in
    {1, 2, 8}, and one mixtral-8x7b layer (E = 4096, 8 experts, i8mm) at
    B = 8."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    cases = [("test-moe", dict(embd=128, inter=256), fmt, layout)
             for fmt, layout in (("Q4_B64T1", "i8mm"), ("Q8_B32T2", "packed"),
                                 ("Q4_B64T1", "i4"))]
    cases.append(("mixtral-8x7b", dict(layers=1), "Q4_B64T1", "i8mm"))
    for name, dims, fmt, layout in cases:
        spec = make_spec(name, device_layout=layout, **dims)
        params = make_synthetic_params(spec, fmt, seed=0, device=dev,
                                       device_layout=layout)
        for lengths in ([9], [4, 21], [3, 9, 4, 2, 6, 0, 11, 5]):
            if name == "mixtral-8x7b" and len(lengths) != 8:
                continue
            worst, agree, same = _one_layer(spec, params["layers"], lengths,
                                            dev, seed=len(lengths))
            assert worst <= ONE_LAYER_TOL, (name, layout, lengths, worst)
            assert agree > 0.5 and same, (name, layout, lengths, agree)
        del params
        torch.cuda.empty_cache()
