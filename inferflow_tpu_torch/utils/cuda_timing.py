"""Device time of a kernel call on the card, and the card's bound.

Used by the kernel bench (tools/kernel_bench.py) and ``chip_smoke.py``.
Times come only from CUDA events on a card; nothing here runs on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor cores, H100 SXM data sheet
TIMED_ITERS = 20


def bound(bytes_moved: float, ops: float, peak: float = H100_BF16_FLOPS
          ) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over its memory rate and the operations over
    `peak` (its rate for their type)."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median device time of a callable over TIMED_ITERS calls, each after
    an L2 flush, measured with CUDA events.

    The flush READS 128 MiB (a write would leave 50 MB of dirty lines whose
    write-back the timed call would pay for).  Each call is queued behind a
    device sleep, so the host enqueues all of the call's launches before
    the device reaches them: the events then time the device work, not the
    host's Python between launches.  An event behind the sleep proves it:
    if the device has passed it by the time the call is queued, the host
    fell behind and the call is timed again behind a four times longer
    sleep.  One call per sleep keeps the queued launches (the fused step
    issues about 115) far below the launch queue's depth, past which the
    host would block.  A callable that waits on the device itself (a
    device-to-host read) can never be queued ahead: it is timed alone, and
    its events then include its host gaps (a "timer" line names it)."""

    SLEEP_CYCLES = 10_000_000  # ~5 ms at the H100's ~2 GHz clock

    def __init__(self, device):
        self.flush_buf = torch.ones(32 * 1024 * 1024, dtype=torch.int32,
                                    device=device)

    def _once(self, fn, sleep_cycles: int):
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        gate = torch.cuda.Event()
        gate.record()
        self.flush_buf.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_ahead = not gate.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end), host_ahead

    def __call__(self, fn, label: str = "", iters: int = TIMED_ITERS) -> float:
        fn()  # warm up
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            for attempt in range(3):
                ms, ahead = self._once(fn, self.SLEEP_CYCLES * 4 ** attempt)
                if ahead:
                    times.append(ms)
                    break
            else:
                break
        if len(times) == iters:
            return float(np.median(times))
        print(json.dumps({"phase": "timer", "ungated": label}), flush=True)
        return float(np.median([self._once(fn, 0)[0]
                                for _ in range(iters)]))
