"""B1's, B5's and B6's decode GEMV on the tensor cores (csrc
dequant_matmul.cuh's ``dq_gemv_mma``) on the card, against the plain
version, for every one of its 17 policies.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_b1_mma.py``.

Tolerance: kernel and plain version multiply the same bf16 weights (the
codec's, B5's i4_weight's, bit for bit: tests/test_torch_b1_mma_codes.py)
and sum in
float32 in other orders: |kernel - plain| <= 8e-3 * max|plain| (two bf16
ulps at the largest output).  The K splits meet in the kernel in a fixed
order: a second call gives the same bits, and the tile counters are left
zero.
"""

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels import dequant_matmul as dm
from inferflow_tpu_torch.quant.codec_torch import (QuantizedTensor,
                                                   pair8_to_wire, quantize,
                                                   repack_i4)
from inferflow_tpu_torch.quant.formats import get_format

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
# (format, layout): the 17 policies (Q4_B32T1B, Q3_B32T1B and Q2_B32T1B
# share the A variants'; "i4": B5's PackedI4 on the i4 layout)
POLICIES = (("Q4_B64T1", "wire"), ("Q8_B32T2", "wire"), ("Q8_B32T1", "wire"),
            ("Q6_B64T1", "wire"), ("Q5_B64T1", "wire"), ("Q5_B32T1", "wire"),
            ("Q4_B32T1A", "wire"), ("Q4_B32T2", "wire"), ("Q4_B16", "wire"),
            ("Q3_B32T1A", "wire"), ("Q2_B32T1A", "wire"),
            ("Q3H_B64T1", "pair8"), ("Q3H_B64T1", "wire"),
            ("Q4_B64T1", "i4"), ("Q4_B32T1A", "i4"), ("Q4_B32T2", "i4"),
            ("Q4_B16", "i4"))
# one row on a single plane of at most 4 bits (the wire planes and the i4
# layout) or a split plane stays on dq_gemv
LOOP_AT_ONE_ROW = {"Q4_B64T1", "Q4_B32T1A", "Q4_B32T2", "Q4_B16",
                   "Q2_B32T1A", "Q5_B32T1"}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _weights(dev, fmt, layout, k, n, gen):
    w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
    qt = quantize(w, fmt)
    if layout == "i4":
        return repack_i4(qt)
    return pair8_to_wire(qt) if layout == "wire" and fmt == "Q3H_B64T1" \
        else qt


def _plain(qt: QuantizedTensor):
    """The plain version of qt's kernel: B5's on the i4 layout."""
    return (dm.i4_matmul_plain if dm.I4_PLANE in qt.planes
            else dm.quantized_matmul_plain)


def _pad_k(qt: QuantizedTensor, k_s: int) -> QuantizedTensor:
    """qt stored with K = k_s: pad blocks of scale 0 and base 0 whose plane
    bytes are 0xA7 (they must add exact zeros whatever they hold)."""
    fmt = get_format(qt.format)
    rows = dm._plane_rows(qt, dm._plane(qt))
    pad = k_s - qt.storage_k
    planes = {nm: torch.nn.functional.pad(
        qt.planes[nm], (0, 0, 0, pad * r // qt.storage_k), value=0xA7)
        for nm, r in rows.items()}
    meta = [None if t is None else torch.nn.functional.pad(
        t, (0, 0, 0, pad // fmt.block)) for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, planes, *meta)


def test_every_policy_every_row_count(dev):
    """Every policy at M = 1..8 (and 12, the tiled path) on a ragged N
    (208, 1040: not multiples of 128) and on llama2-7b's w2 K (11008)
    stored K-padded to 11264: counted launches, the plain version's
    result, the same bits twice, the tile counters left zero."""
    gen = torch.Generator(device=dev).manual_seed(18)
    for fmt, layout in POLICIES:
        for k, n, k_s in ((704, 208, None), (11008, 1040, 11264)):
            qt = _weights(dev, fmt, layout, k, n, gen)
            qt = qt if k_s is None else _pad_k(qt, k_s)
            kernel = dm.kernel_name(qt)
            for m in (1, 2, 3, 4, 5, 6, 7, 8, 12):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                before = _build.launch_counts[kernel]
                got = dm.quantized_matmul(x, qt)
                again = dm.quantized_matmul(x, qt)
                ref = _plain(qt)(x, qt)
                torch.cuda.synchronize()
                assert _build.launch_counts[kernel] == before + 2
                assert got.shape == (m, n) and got.dtype == torch.bfloat16
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                assert err <= REL_TOL * scale + 1e-6, (fmt, layout, k, m, err)
                assert torch.equal(got, again), (fmt, layout, k, m)
    for buf in dm._COUNTERS.values():
        assert not buf.any()


def _kernels_launched(fn) -> str:
    """The names of the device kernels one call of fn launches (as
    chip_smoke.profile_decode reads them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()
                     if e.device_type != DeviceType.CPU)
    assert names, "the profiler saw no device kernel"
    return names


def test_routes_by_policy_and_rows(dev):
    """Every policy runs dq_gemv_mma at 2-8 rows and, but for the single
    planes of at most 4 bits (B5's i4 layout among them) and the split
    plane, at one row, where they run dq_gemv; more than 8 rows dq_gemm."""
    gen = torch.Generator(device=dev).manual_seed(19)
    for fmt, layout in POLICIES:
        qt = _weights(dev, fmt, layout, 1024, 512, gen)
        for m in (1, 8, 12):
            x = torch.randn((m, 1024), generator=gen, device=dev).to(
                torch.bfloat16)
            names = _kernels_launched(lambda: dm.quantized_matmul(x, qt))
            if m == 12:
                want = "dq_gemm"
            elif m == 1 and layout != "pair8" and fmt in LOOP_AT_ONE_ROW:
                want = "dq_gemv<"
            else:
                want = "dq_gemv_mma<"
            assert want in names, (fmt, layout, m, names)
            if want == "dq_gemv<":
                assert "dq_gemv_mma" not in names, (fmt, layout, names)


def test_refused_plan_and_failed_build_raise(dev, monkeypatch):
    """A decode plan that leaves K uncovered is refused by the C entry,
    and a build that fails raises before any launch (no fallback to the
    plain version)."""
    qt = quantize(torch.randn((512, 256), device=dev) * 0.05, "Q6_B64T1")
    x = torch.randn((4, 512), device=dev).to(torch.bfloat16)
    lib = dm._lib("subbyte_matmul")
    out = torch.empty((4, 256), dtype=torch.bfloat16, device=dev)
    work = torch.empty((8, 4, 256), dtype=torch.float32, device=dev)
    counters = dm._counters(x, 2)
    rc = lib.ift_q6_matmul(
        _build.ptr(x), _build.ptr(qt.planes["data"]),
        _build.ptr(qt.planes["data_h"]), _build.ptr(qt.scale),
        _build.ptr(qt.base), _build.ptr(out), _build.ptr(work),
        _build.ptr(counters), 4, 512, 256, 1, 7, _build.stream_of(x))
    assert rc != 0
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("--no-such-nvcc-option",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dm.quantized_matmul(x, qt)
