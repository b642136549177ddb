"""The kernels of the kernel bench's slice on the card, against their plain
versions, at small shapes: kernel B6's wire mode (``q3h_wire_matmul``) and
non-pair branch (``generic_matmul``), the unpack experiments X1-X5
(``unpack_a`` ... ``unpack_e``), and B2, B3 and B7 at head_dim 256 and at
more than 16 query heads per kv head; then the kernel bench's own exit
code.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_kernel_bench.py``.

Tolerances: the dequantize-matmul kernels and their plain versions
multiply the same bf16 weights and sum in float32 in other orders:
|kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps at the largest
output); X1-X4 within 2^-7 * max|plain|, X5 exact (int32 sums); the
attention kernels within 8e-3 * max|plain| (float32 softmax in another
order).
"""

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels import attention as att
from inferflow_tpu_torch.kernels import dequant_matmul as dm
from inferflow_tpu_torch.quant.codec_torch import pair8_to_wire, quantize
from inferflow_tpu_torch.runtime.kv_cache import KVCache
from inferflow_tpu_torch.tools import exp_unpack, kernel_bench

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _close(got, ref, tol=REL_TOL):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item() + 1e-6, err


def test_b6_wire_and_generic(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    k, n = 1024, 384
    w = torch.randn((k, n), generator=gen, device=dev) * 0.03
    wire = pair8_to_wire(quantize(w, "Q3H_B64T1"))
    cases = [(wire, dm.quantized_matmul, dm.quantized_matmul_plain,
              "q3h_wire_matmul")]
    cases += [(quantize(w, fmt), dm.generic_matmul, dm.generic_matmul_plain,
               "generic_matmul") for fmt in kernel_bench.NONPAIR_FORMATS]
    for qt, fn, plain, name in cases:
        for m in (1, 5, 8, 40):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            before = _build.launch_counts[name]
            got = fn(x, qt)
            assert _build.launch_counts[name] == before + 1
            _close(got, plain(x, qt))
            assert torch.equal(got, fn(x, qt))  # fixed summation order


@pytest.mark.parametrize("name", ["a", "b", "c", "d", "e"])
def test_unpack_kernel(dev, name):
    gen = torch.Generator(device=dev).manual_seed(1)
    inp = exp_unpack.mk_inputs(1024, 640, gen, dev)
    case = next(c for c in exp_unpack.cases(inp)
                if c[0] == f"unpack_{name}")
    _, kern, plain, _, _, _, _, int8 = case
    before = _build.launch_counts[f"unpack_{name}"]
    got = kern()
    assert _build.launch_counts[f"unpack_{name}"] == before + 1
    if int8:
        torch.cuda.synchronize()
        assert torch.equal(got, plain())
    else:
        _close(got, plain(), 2.0 ** -7)


def test_attention_head_dim_256_and_wide_groups(dev):
    """B2 and B3 at D = 256 (g = 8), at D = 64 with 20 query heads per kv
    head and at D = 80 (a head dim the JAX kernels refuse), B7 at D = 256
    and 64, each against its plain version and each launching its kernel;
    B7 at D = 80 raises."""
    gen = torch.Generator(device=dev).manual_seed(2)
    for h, g, d in ((1, 8, 256), (2, 20, 64), (2, 3, 80)):
        cache = KVCache.create(1, 3, 768, h, d, quantized=True, device=dev)
        rows = torch.randn((3, 600, h, d), generator=gen, device=dev)
        cache.update_layer(0, rows, rows.flip(1),
                           torch.zeros(3, dtype=torch.int32, device=dev))
        lengths = torch.tensor([600, 333, 1], dtype=torch.int32, device=dev)
        q = torch.randn((3, 1, h * g, d), generator=gen, device=dev).to(
            torch.bfloat16)
        name = att.kernel_name(att.DECODE_KERNEL, d)
        before = _build.launch_counts[name]
        got = att.decode_attention(q, cache, 0, lengths)[0][:, 0]
        assert _build.launch_counts[name] == before + 1, (name, d)
        _close(got, att.decode_attention_plain(q[:, 0], cache, 0, lengths))
        qc = torch.randn((1, 96, h * g, d), generator=gen, device=dev).to(
            torch.bfloat16)
        name = att.kernel_name(att.CHUNK_KERNEL, d)
        before = _build.launch_counts[name]
        got = att.chunk_attention(qc, cache, 0, 1, 300)[0][0]
        assert _build.launch_counts[name] == before + 1, (name, d)
        _close(got, att.chunk_attention_plain(qc[0], cache, 0, 1, 300))
        paged = kernel_bench._paged_copy(cache, gen)
        if d == 80:
            with pytest.raises(NotImplementedError):
                att.decode_attention(q, paged, 0, lengths)
            continue
        name = att.kernel_name(att.PAGED_KERNEL, d)
        before = _build.launch_counts[name]
        got = att.decode_attention(q, paged, 0, lengths)[0][:, 0]
        assert _build.launch_counts[name] == before + 1, (name, d)
        _close(got, att.paged_decode_attention_plain(q[:, 0], paged, 0,
                                                     lengths))


def test_kernel_bench_exit_code(dev, monkeypatch):
    monkeypatch.setenv("EXP_SHAPE", "1024x640")
    args = ["--k", "1024", "--n", "384", "--m", "1,20", "--b6", "--unpack",
            "--formats", "Q4_B64T1,Q3H_B64T1", "--skip-perf"]
    assert kernel_bench.main(args) == 0
    assert kernel_bench.main(args + ["--tol", "-1"]) == 1
