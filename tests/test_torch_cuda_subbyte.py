"""Kernel B1 on the sub-byte block formats (launch count
``subbyte_matmul``) on the card, against its plain version.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_subbyte.py``.

Tolerance: the kernel and its plain version multiply the same bf16
weights, bf16(code*sc + base) (the codec's), and sum in float32 in other
orders: |kernel - plain| <= 8e-3 * max|plain| (two bf16 ulps at the
largest output).  The kernel gives the same bits on a second launch (its
split partials are added in a fixed order).
"""

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor, quantize
from inferflow_tpu_torch.quant.formats import get_format

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3
FORMATS = ("Q6_B64T1", "Q5_B64T1", "Q5_B32T1", "Q4_B32T1A", "Q4_B32T1B",
           "Q4_B32T2", "Q4_B16", "Q3_B32T1A", "Q3_B32T1B", "Q2_B32T1A",
           "Q2_B32T1B")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _pad_k(qt: QuantizedTensor, k_s: int) -> QuantizedTensor:
    """qt stored with K = k_s: zero-scale, zero-base pad blocks whose plane
    bytes are 0x5A (they must add exact zeros whatever they hold)."""
    fmt = get_format(qt.format)
    pad = k_s - qt.storage_k
    planes = {p.name: torch.nn.functional.pad(
        qt.planes[p.name], (0, 0, 0, pad * p.bits // 8), value=0x5A)
        for p in fmt.planes}
    meta = [torch.nn.functional.pad(t, (0, 0, 0, pad // fmt.block))
            for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, planes, *meta)


def test_subbyte_matmul_kernel(dev):
    """Every sub-byte format: the decode GEMV (M <= 8, M = 8 the serving
    batch), the tiled kernel (M = 12, 256) at a small shape and at
    llama2-7b's w2 width (K = 11008 stored K-padded to 11264); counted
    launches, the same bits twice."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from inferflow_tpu_torch.ops.linear import linear
    gen = torch.Generator(device=dev).manual_seed(81)
    for fmt in FORMATS:
        for k, n, k_s in ((192, 512, None), (11008, 1024, 11264)):
            w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
            qt = quantize(w, fmt)
            qt = qt if k_s is None else _pad_k(qt, k_s)
            for m in (1, 3, 8, 12, 256):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                before = _build.launch_counts["subbyte_matmul"]
                got = linear(x, qt)
                ref = quantized_matmul_plain(x, qt)
                torch.cuda.synchronize()
                assert _build.launch_counts["subbyte_matmul"] == before + 1
                assert got.shape == (m, n) and got.dtype == torch.bfloat16
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= REL_TOL * ref.float().abs().max().item() + 1e-6, \
                    (fmt, k, n, k_s, m, err)
                assert torch.equal(quantized_matmul(x, qt), got)
