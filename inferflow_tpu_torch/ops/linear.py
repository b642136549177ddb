"""Linear layer dispatch over dense or quantized weights.

Port of inferflow_tpu/ops/linear.py for the dense, QuantizedTensor and
Int8MXUTensor cases:
  - a QuantizedTensor goes to kernels/dequant_matmul.quantized_matmul,
    which picks the kernel from the weight's plane and format (B1 for the
    wire planes of every block format but Q3H, from Q2 to Q8, B5 for the
    i4 layout's ``data_i4p``, B6 for Q3H's ``pair8``; the plain versions
    on CPU tensors);
  - an Int8MXUTensor (device layout 'i8mm') to the int8 x int8 product
    with per-row activation and per-column weight scales
    (kernels/decode_step.i8mm_matmul);
  - a dense weight to a float32-accumulated matmul.
The global-quant and delta weight types are not ported.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels.decode_step import i8mm_matmul
from ..kernels.dequant_matmul import quantized_matmul
from ..quant.codec_torch import Int8MXUTensor, QuantizedTensor

Weight = Union[torch.Tensor, QuantizedTensor, Int8MXUTensor]


def linear(x: torch.Tensor, w: Weight,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ bias); x: (..., K), w: (K, N)."""
    if isinstance(w, Int8MXUTensor):
        y = i8mm_matmul(x, w)
    elif isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w)
    elif isinstance(w, torch.Tensor):
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    else:
        raise NotImplementedError(f"weight type {type(w).__name__} "
                                  "is not ported")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
