"""The port's codec against the golden data of tests/golden/data (made by
compiling the reference's own quantization headers, gen_golden.cc), for
all 14 wire formats that have it: ``codec_torch.quantize`` reproduces the
reference's block bytes, and ``codec_torch.dequantize`` its float32
values, exactly.  Q3H comes out of the port's quantize as the pair8 plane
(one byte per base-11 pair code); its wire planes for the byte comparison
are the same pair codes split into the format's 4-, 2- and 1-bit planes.
"""

import os

import numpy as np
import pytest
import torch

from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.quant.formats import get_format

from test_quant import GOLDEN_FORMATS, _interleave_to_structs

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "data")


def _wire_dict(qt: codec_torch.QuantizedTensor) -> dict:
    """The port's tensor as a wire-plane numpy dict (pair8 split into the
    Q3H planes)."""
    fmt = get_format(qt.format)
    planes = qt.planes
    if codec_torch.PAIR8_PLANE in planes:
        pair = planes[codec_torch.PAIR8_PLANE].to(torch.int32)
        planes = codec_torch._pack_planes(pair, fmt)
    return {"format": qt.format, "shape": qt.shape,
            "planes": {k: v.numpy() for k, v in planes.items()},
            "scale": qt.scale.numpy(),
            "base": None if qt.base is None else qt.base.numpy()}


@pytest.mark.parametrize("what", ["block_bytes", "dequant_values"])
def test_golden_data(what):
    assert len(GOLDEN_FORMATS) == 14
    for fmt in GOLDEN_FORMATS:
        src = np.fromfile(os.path.join(GOLDEN, f"{fmt}.input.f16.bin"),
                          dtype=np.float16)
        qt = codec_torch.quantize(
            torch.from_numpy(src.astype(np.float32)).reshape(-1, 1), fmt)
        if what == "block_bytes":
            with open(os.path.join(GOLDEN, f"{fmt}.blocks.bin"), "rb") as fh:
                ref = fh.read()
            assert _interleave_to_structs(_wire_dict(qt)) == ref, fmt
        else:
            ref = np.fromfile(os.path.join(GOLDEN, f"{fmt}.dequant.f32.bin"),
                              dtype=np.float32)
            got = codec_torch.dequantize(qt, torch.float32).numpy()
            np.testing.assert_array_equal(got.reshape(-1), ref, err_msg=fmt)
