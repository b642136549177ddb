"""The PyTorch package stands alone, and nothing in it falls back silently.

- Importing every module of ``inferflow_tpu_torch`` (in a fresh process;
  ``config/``, ``runtime/paged_kv.py``, the loaders, the tokenizer,
  ``runtime/factory.py``, ``serving/`` and ``tools/`` among them) leaves
  ``jax`` and ``inferflow_tpu`` out of ``sys.modules``; no module of it,
  nothing in ``chip_smoke.py`` and no card test
  (``tests/test_torch_cuda*.py``) names them in an import.
- Entry points (the zoo, the engine, ``InferenceEngine.from_config``,
  ``make_engine``, ``load_model``, ``load_std``, the synthetic checkpoint
  writer, the service and llm_inference CLIs) default to the card and
  raise where there is none; the kernel
  wrappers (B1 for Q4, Q8 and the sub-byte weights, B2, B3, B5 on every
  4-bit format, B6, B7, the i8mm product and the fused decode step B4,
  dense and paged, i8mm, i4 (every block geometry) and byte, and its
  routed-expert mode (g) with its routing launch) raise for a tensor that
  is neither on the CPU nor on a card, and the kernel build raises
  without a CUDA compiler.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "inferflow_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import inferflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "inferflow_tpu"
             or m.startswith("inferflow_tpu."))
missing = [n for n in ("inferflow_tpu_torch.config.ini",
                       "inferflow_tpu_torch.config.model_spec",
                       "inferflow_tpu_torch.config.engine_config",
                       "inferflow_tpu_torch.runtime.paged_kv",
                       "inferflow_tpu_torch.runtime.factory",
                       "inferflow_tpu_torch.loaders.model_loader",
                       "inferflow_tpu_torch.loaders.std_format",
                       "inferflow_tpu_torch.loaders.synthetic",
                       "inferflow_tpu_torch.tokenizer.loading",
                       "inferflow_tpu_torch.utils.study",
                       "inferflow_tpu_torch.models.network_structure",
                       "inferflow_tpu_torch.serving.service_data",
                       "inferflow_tpu_torch.serving.http_server",
                       "inferflow_tpu_torch.serving.client",
                       "inferflow_tpu_torch.tools.inferflow_service",
                       "inferflow_tpu_torch.tools.llm_inference",
                       "inferflow_tpu_torch.tools.inferflow_client")
           if n not in names]
print(len(names), bad + missing)
"""


def test_import_all_modules_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 35
    assert bad == "[]"


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    cards = sorted((ROOT / "tests").glob("test_torch_cuda*.py"))
    assert len(cards) >= 5
    paths = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + cards
    assert len(paths) >= 20
    for path in paths:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "inferflow_tpu"), (path, name)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache
    from inferflow_tpu_torch.weights import params_from_numpy
    spec = make_spec("test-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_params(spec, "Q4_B64T1")
    params = make_synthetic_params(spec, "Q4_B64T1", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(spec, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCache.create(1, 1, 16, 2, 32, quantized=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache.create(1, 1, 512, 2, 32, quantized=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantizedTensor.from_np(params["lm_head"].to_np())
    q3h = make_synthetic_params(spec, "Q3H_B64T1", device="cpu",
                                device_layout="packed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantizedTensor.from_np(q3h["lm_head"].to_np())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"layers": [],
                           "lm_head": params["lm_head"].to_np()})
    # engine construction from config and checkpoints on disk
    from inferflow_tpu_torch.config import EngineConfig
    from inferflow_tpu_torch.loaders.model_loader import load_model
    from inferflow_tpu_torch.loaders.std_format import load_std
    from inferflow_tpu_torch.loaders.synthetic import write_llama_checkpoint
    from inferflow_tpu_torch.runtime.factory import make_engine
    config = EngineConfig(models=[make_spec("test-tiny")])
    for build in (lambda: make_engine(config),
                  lambda: InferenceEngine.from_config(config),
                  lambda: load_model(make_spec("test-tiny"), "."),
                  lambda: load_std("unused.safetensors"),
                  lambda: write_llama_checkpoint("unused", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the CLIs (the service and llm_inference) run on the card unless
    # --device cpu
    from inferflow_tpu_torch.tools import inferflow_service, llm_inference
    for main in (inferflow_service.main, llm_inference.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--zoo", "test-tiny", "--quant", "Q4_B64T1"])


def test_wrappers_refuse_other_devices():
    from inferflow_tpu_torch.kernels.attention import (chunk_attention,
                                                       decode_attention)
    from inferflow_tpu_torch.kernels.dequant_matmul import quantized_matmul
    from inferflow_tpu_torch.quant import codec_torch
    from inferflow_tpu_torch.quant.codec_torch import quantize
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache

    qt = quantize(torch.randn(128, 64), "Q4_B64T1")
    with pytest.raises(ValueError, match="unsupported device"):
        quantized_matmul(torch.empty((2, 128), device="meta"), qt)
    cache = KVCache.create(1, 1, 16, 2, 32, quantized=True, device="cpu")
    q = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, cache, 0, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        chunk_attention(q, cache, 0, 0, 0)
    paged = PagedKVCache.create(1, 1, 512, 2, 32, quantized=True,
                                device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, paged, 0, torch.ones(1, dtype=torch.int32))

    # the i8mm product and the whole-model fused decode step (kernel B4)
    from inferflow_tpu_torch.kernels.decode_step import (fused_decode_step,
                                                         i8mm_matmul)
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    w = codec_torch.requantize_i8_colwise(torch.randn(128, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        i8mm_matmul(torch.empty((2, 128), device="meta"), w)
    spec = make_spec("test-llama", layers=1)
    params = make_synthetic_params(spec, "Q4_B64T1", device="cpu",
                                   device_layout="i8mm")
    hp = spec.hyper_params
    cache = KVCache.create(1, 2, 16, hp.kv_heads, hp.head_dim,
                           quantized=True, device="cpu")
    x = torch.empty((2, 1, hp.embd_dims), dtype=torch.bfloat16,
                    device="meta")
    i4 = make_synthetic_params(spec, "Q4_B64T1", device="cpu",
                               device_layout="i4")
    i4_formats = [make_synthetic_params(spec, fmt, device="cpu",
                                        device_layout="i4")
                  for fmt in ("Q4_B32T1A", "Q4_B32T2", "Q4_B16")]
    for c in (cache, PagedKVCache.create(1, 2, 512, hp.kv_heads, hp.head_dim,
                                         quantized=True, device="cpu")):
        for p in [params, i4] + i4_formats:
            with pytest.raises(ValueError, match="unsupported device"):
                fused_decode_step(spec, p["layers"], x,
                                  torch.zeros((2, 1), dtype=torch.int32), c)

    # kernel B5 (the i4 layout's products) and kernel B6 (Q3H pair8)
    from inferflow_tpu_torch.ops.linear import linear
    q3h = make_synthetic_params(spec, "Q3H_B64T1", device="cpu",
                                device_layout="packed")
    assert set(q3h["lm_head"].planes) == {"pair8"}
    for w in [i4["lm_head"], q3h["lm_head"]] + [p["lm_head"]
                                                for p in i4_formats]:
        for fn in (quantized_matmul, linear):
            with pytest.raises(ValueError, match="unsupported device"):
                fn(torch.empty((2, hp.embd_dims), device="meta"), w)
    # the fused step has no pair8 mode: it raises whatever the device
    with pytest.raises(NotImplementedError, match=r"mode \(h\)"):
        fused_decode_step(spec, q3h["layers"], x,
                          torch.zeros((2, 1), dtype=torch.int32), cache)

    # B1's Q8 case and the fused step's byte mode (Q8_B32T2, the q8c
    # container, and Q8_B32T1)
    for fmt, layout in (("Q8_B32T2", ""), ("Q4_B64T1", "q8c"),
                        ("Q8_B32T1", "")):
        q8 = make_synthetic_params(spec, fmt, device="cpu",
                                   device_layout=layout)
        assert q8["lm_head"].format.startswith("Q8_")
        for fn in (quantized_matmul, linear):
            with pytest.raises(ValueError, match="unsupported device"):
                fn(torch.empty((2, hp.embd_dims), device="meta"),
                   q8["lm_head"])
        with pytest.raises(ValueError, match="unsupported device"):
            fused_decode_step(spec, q8["layers"], x,
                              torch.zeros((2, 1), dtype=torch.int32), cache)

    # B1's sub-byte case: two planes, split nibbles, f32 metadata, 2 bits
    for fmt in ("Q6_B64T1", "Q5_B32T1", "Q4_B16", "Q2_B32T1A"):
        w = quantize(torch.randn(128, 64), fmt)
        for fn in (quantized_matmul, linear):
            with pytest.raises(ValueError, match="unsupported device"):
                fn(torch.empty((2, 128), device="meta"), w)

    # the fused step's routed-expert mode (g) and its routing launch
    from inferflow_tpu_torch.kernels.decode_step import moe_route
    moe_spec = make_spec("test-moe", embd=128, inter=256, layers=1)
    mhp = moe_spec.hyper_params
    moe_cache = KVCache.create(1, 2, 16, mhp.kv_heads, mhp.head_dim,
                               quantized=True, device="cpu")
    xm = torch.empty((2, 1, 128), dtype=torch.bfloat16, device="meta")
    for layout in ("i8mm", "q8c", "i4"):
        moe = make_synthetic_params(moe_spec, "Q4_B64T1", device="cpu",
                                    device_layout=layout)
        assert "experts_stacked" in moe["layers"][0]["moe"]
        with pytest.raises(ValueError, match="unsupported device"):
            fused_decode_step(moe_spec, moe["layers"], xm,
                              torch.zeros((2, 1), dtype=torch.int32),
                              moe_cache)
    gate = moe["layers"][0]["moe"]["gate"]
    with pytest.raises(ValueError, match="unsupported device"):
        moe_route(xm[:, 0], torch.ones(128, dtype=torch.bfloat16), gate, 2,
                  True, 1e-5)


def test_kernel_build_needs_nvcc():
    from inferflow_tpu_torch.kernels import _build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA compiler is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
