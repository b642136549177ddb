"""Device time of a kernel call on the card, and the card's bound.

Used by the kernel bench (tools/kernel_bench.py) and ``chip_smoke.py``.
Times come only from CUDA events on a card; nothing here runs on the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor cores, H100 SXM data sheet
TIMED_ITERS = 20
# a callable whose call after the warm-up takes longer than SLOW_S (a
# plain version of a many-layer decode step takes 0.05-1.9 s, all of it
# the host's launches) is read from that call on the host clock
SLOW_S = 0.05


def bound(bytes_moved: float, ops: float, peak: float = H100_BF16_FLOPS
          ) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over its memory rate and the operations over
    `peak` (its rate for their type)."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median device time of a callable over `iters` calls (TIMED_ITERS
    unless the constructor or the call asks for another count), each after
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
    its events then include its host gaps (a "timer" line names it).
    A callable whose call after the warm-up takes longer than SLOW_S is
    read from that one call on the host clock (a "timer" line names it): a
    sleep of at most 16 ms cannot cover its host time (the plain versions
    of the decode steps spend 0.05-1.9 s launching small kernels), and
    more calls would only repeat a host-bound reading."""

    # ~1 ms at the H100's ~2 GHz clock: enough for a single kernel's
    # launch; a callable whose launches take the host longer (a fused
    # step's 160) is timed again behind 4x and 16x that
    SLEEP_CYCLES = 2_000_000

    def __init__(self, device, iters: int = TIMED_ITERS):
        self.iters = iters
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

    def __call__(self, fn, label: str = "", iters: int = 0) -> float:
        iters = iters or self.iters
        fn()  # warm up (a first call may build or load a kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if call_s > SLOW_S:
            print(json.dumps({"phase": "timer", "host_clock_once": label}),
                  flush=True)
            return call_s * 1e3
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
        return self._alone(fn, label, iters)

    def _alone(self, fn, label: str, iters: int) -> float:
        """Median over `iters` calls, each timed without a sleep ahead of
        it: its events include the host's gaps between its launches."""
        print(json.dumps({"phase": "timer", "ungated": label}), flush=True)
        return float(np.median([self._once(fn, 0)[0]
                                for _ in range(iters)]))
