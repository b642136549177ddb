"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
Libraries are built at first use into ``build/inferflow_tpu_torch/`` at the
root of the checkout, named after a hash of the source, the headers under
``csrc/`` and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  ``start()`` begins compiles without waiting
for them; ``build()`` and ``load()`` then wait for their own sources only.

Every pointer and the stream cross into C as ``ctypes.c_void_p``; each C
entry returns the ``cudaGetLastError()`` of its launch and the wrapper
raises when it is not 0.  Wrappers count their launches in
``launch_counts`` (one per call that launches its kernel).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "inferflow_tpu_torch"
SOURCES = ("dequant_matmul", "subbyte_matmul", "unpack_exp",
           "attention", "decode_step")
# --split-compile=0: nvcc runs a source's optimization passes on every
# core it finds, which shortens the longest build (decode_step.cu's)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")
# sources compiled as several translation units at once (-DIFT_PARTS=n,
# -DIFT_PART=p) and linked into one library: decode_step.cu's GEMV
# instantiations are the longest build by far
PARTS = {"decode_step": 4}

# kernel name -> launches since the last clear()
launch_counts: collections.Counter = collections.Counter()

_libs: dict = {}
# source name -> (library, temporary file, part objects, nvcc processes)
# of a compile that start() began and no build() has waited for yet
_pending: dict = {}
_lock = threading.RLock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(str(PARTS.get(name, 1)).encode())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start(names=SOURCES, ptxas_verbose: bool = False) -> None:
    """Start the nvcc processes of every source of ``names`` that is
    neither built nor being built (one per source, or one per part of a
    source in PARTS), all together, and return at once; build() and load()
    wait for a source's own compile."""
    nvcc = _nvcc()
    verbose = ("-Xptxas", "-v") if ptxas_verbose else ()
    with _lock:
        for name in names:
            out = library_path(name)
            if out.exists() or name in _pending:
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            src = str(CSRC / f"{name}.cu")
            n = PARTS.get(name, 1)
            objs = ([tmp.with_name(f"{tmp.name}.{p}.o") for p in range(n)]
                    if n > 1 else [])
            if objs:
                flags = [f for f in NVCC_FLAGS if f != "-shared"]
                cmds = [[nvcc, *flags, *verbose, f"-DIFT_PARTS={n}",
                         f"-DIFT_PART={p}", "-c", "-o", str(obj), src]
                        for p, obj in enumerate(objs)]
            else:
                cmds = [[nvcc, *NVCC_FLAGS, *verbose, "-o", str(tmp), src]]
            _pending[name] = (out, tmp, objs, [subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd in cmds])


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict:
    """Compile every source of ``names`` that is not built yet (start())
    and wait for each; a source in PARTS is linked from its parts once
    they are all compiled.  Returns {name: compiler output} for the
    sources compiled by this call or by an earlier start(); raises if any
    compile failed."""
    start(names, ptxas_verbose)
    logs, failed = {}, []
    with _lock:
        for name in names:
            if name not in _pending:
                continue
            out, tmp, objs, procs = _pending.pop(name)
            logs[name] = "".join(proc.communicate()[0] for proc in procs)
            ok = all(proc.returncode == 0 for proc in procs)
            if ok and objs:
                link = subprocess.run(
                    [_nvcc(), "-shared", "-o", str(tmp),
                     *(str(obj) for obj in objs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                logs[name] += link.stdout
                ok = link.returncode == 0
            for obj in objs:
                obj.unlink(missing_ok=True)
            if ok:
                os.replace(tmp, out)
            else:
                failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.ift_error_string.argtypes = [ctypes.c_int]
            lib.ift_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ift_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def require_hopper(t: torch.Tensor) -> None:
    """The kernels are compiled for sm_90a only."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the CUDA kernels are built for sm_90a; "
                           f"{torch.cuda.get_device_name(t.device)} is "
                           f"sm_{cap[0]}{cap[1]}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_operand(t: torch.Tensor, name: str, dtype, shape=None,
                  align: int = 16) -> None:
    """Device, dtype, shape, contiguity and alignment of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
