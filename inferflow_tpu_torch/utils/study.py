"""Study mode (golden tensor dumps) + per-phase perf statistics.

A copy of inferflow_tpu/utils/study.py (no JAX in it), kept so that this
package imports nothing of the JAX one.

reference: `is_study_mode` / `show_tensors` dump intermediate tensors with
stable integer tags to tensor_dump.txt (inference_engine.cc:59-63,
inference_worker.cc:2641-2668) enabling golden diffing against another
implementation; `enable_perf_stat` fills InferencePerfStat's int-keyed
time map with keys `(layer+1)*10000 + phase`
(inference_worker.cc:318-321,783, inference_types.h:111).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, TextIO

import numpy as np

from .tensor_util import tensor_to_json

# stable phase tags (mirroring the reference's integer tag convention)
TAG_EMBD = 10203
TAG_PRE_NORM = 10301
TAG_ATTN_OUT = 10500
TAG_FFN_OUT = 10600
TAG_LAYER_OUT = 10700
TAG_OUTPUT_NORM = 10800
TAG_LOGITS = 10900

PHASE_LAYER_START = 10
PHASE_SELF_ATTN = 11
PHASE_FFN = 12
PHASE_LAYER_END = 29


def perf_key(layer: int, phase: int) -> int:
    """(layer+1)*10000 + phase (inference_worker.cc:318-321)."""
    return (layer + 1) * 10000 + phase


class StudyMode:
    """Tensor dump sink for golden diffs.

    Enabled instances collect (tag, layer, name) -> summary lines in
    tensor_dump.txt-compatible format; disabled instances are no-ops so
    call sites stay unconditional."""

    def __init__(self, enabled: bool = False, show_tensors: bool = False,
                 path: str = "tensor_dump.txt"):
        self.enabled = enabled
        self.show_tensors = show_tensors
        self.path = path
        self._fh: Optional[TextIO] = None

    def _file(self) -> TextIO:
        if self._fh is None:
            self._fh = open(self.path, "w", encoding="utf-8")
        return self._fh

    def dump(self, tag: int, value, layer: int = -1, name: str = "") -> None:
        if not self.enabled:
            return
        arr = np.asarray(value, np.float32)
        fh = self._file()
        fh.write(f"({tag}) layer={layer} {name} shape={list(arr.shape)} "
                 f"mean={arr.mean():.6g} std={arr.std():.6g} "
                 f"min={arr.min():.6g} max={arr.max():.6g}\n")
        if self.show_tensors:
            fh.write(tensor_to_json(arr, 64) + "\n")
        fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class PerfStat:
    """Int-keyed phase timing map (InferencePerfStat, inference_types.h:111).

    Keys follow perf_key(layer, phase); value is accumulated milliseconds.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.time_map: Dict[int, float] = {}

    @contextlib.contextmanager
    def measure(self, key: int):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.time_map[key] = (self.time_map.get(key, 0.0)
                                  + (time.time() - t0) * 1e3)

    def add(self, key: int, ms: float) -> None:
        if self.enabled:
            self.time_map[key] = self.time_map.get(key, 0.0) + ms

    def print_stat(self, file=None) -> str:
        """PrintPerfStat-compatible listing (inference_worker.cc:2670)."""
        lines = []
        for key in sorted(self.time_map):
            layer = key // 10000 - 1
            phase = key % 10000
            lines.append(f"{key}\tlayer={layer}\tphase={phase}\t"
                         f"{self.time_map[key]:.3f} ms")
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    def save(self, path: str = "perf_stat.txt") -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.print_stat() + "\n")
