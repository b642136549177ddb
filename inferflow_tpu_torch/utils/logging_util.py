"""Logging + memory statistics (port of inferflow_tpu/utils/logging_util.py,
whose device statistics come from JAX).

reference: sslib Logger with leveled macros writing console+file per
[app_env.logging] (3rd_party/sslib/log.h:208-228, app_environment.h), and
the engine's VRAM statistics at startup (CalculateStat,
inference_engine.cc:1879-1910; KV cost inference_worker.cc:178-182).
The device numbers here are the torch allocator's on the card the engine
runs on (none on the CPU).
"""

from __future__ import annotations

import logging
import sys

import torch

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def init_logging(level: str = "info", log_file: str = "",
                 console: bool = True) -> logging.Logger:
    """InitAppEnv-style logging setup (console + optional file)."""
    root = logging.getLogger("inferflow_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    fmt = logging.Formatter(_FMT)
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger("inferflow_tpu_torch"
                             + (f".{name}" if name else ""))


def weight_bytes(params) -> int:
    """Total bytes of a params tree: tensors and quantized weights (their
    planes and metadata) alike (models/zoo.model_weight_bytes in the JAX
    package)."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(weight_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return int(getattr(params, "nbytes", 0))


def memory_stat(params: dict, cache=None) -> dict:
    """Weight/KV byte accounting (the CalculateStat analog), with the
    allocator's bytes in use and the card's capacity when the cache (or
    the weights) live on a card."""
    stat = {"weight_bytes": weight_bytes(params)}
    if cache is not None:
        stat["kv_cache_bytes"] = sum(
            t.numel() * t.element_size()
            for t in (cache.k, cache.v, getattr(cache, "k_scale", None),
                      getattr(cache, "v_scale", None)) if t is not None)
        dev = cache.k.device
        if dev.type == "cuda":
            stat["bytes_in_use"] = torch.cuda.memory_allocated(dev)
            stat["bytes_limit"] = torch.cuda.get_device_properties(
                dev).total_memory
    return stat


def log_memory_stat(params: dict, cache=None, logger=None) -> dict:
    stat = memory_stat(params, cache)
    lg = logger or get_logger("engine")
    parts = [f"{k}={v / 1e9:.2f}GB" if "bytes" in k else f"{k}={v}"
             for k, v in stat.items()]
    lg.info("memory: %s", " ".join(parts))
    return stat
