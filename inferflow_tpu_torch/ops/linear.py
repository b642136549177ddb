"""Linear layer dispatch over dense or block-quantized weights.

Port of inferflow_tpu/ops/linear.py for the dense and QuantizedTensor
cases: a QuantizedTensor goes to the dequant-matmul kernel wrapper
(kernels/dequant_matmul.py; the plain version on CPU tensors), a dense
weight to a float32-accumulated matmul.  The i8mm, global-quant and delta
weight types are not ported.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels.dequant_matmul import quantized_matmul
from ..quant.codec_torch import QuantizedTensor

Weight = Union[torch.Tensor, QuantizedTensor]


def linear(x: torch.Tensor, w: Weight,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ bias); x: (..., K), w: (K, N)."""
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w)
    elif isinstance(w, torch.Tensor):
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    else:
        raise NotImplementedError(f"weight type {type(w).__name__} "
                                  "is not ported")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
