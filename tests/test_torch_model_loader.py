"""The port's ``load_model`` against the JAX package's, on one synthetic
safetensors checkpoint (Hugging Face llama names, bf16, sharded through an
index) written in a temporary directory.

The port quantizes each tensor on its device with ``codec_torch.quantize``
where the JAX loader uses ``quant/codec_native``: the two give the same
bytes (held here for every block format), so the loaded leaves are equal,
byte for byte for the codes and metadata and value for value for the bf16
leaves, in the packed, i4 and i8mm layouts.  The JAX loader pads K to its
TPU tile where the port does not (ROADMAP C): its pad rows are not
compared.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from inferflow_tpu.loaders import model_loader as jml
from inferflow_tpu.models.spec import ModelSpec as JSpec
from inferflow_tpu.quant import codec_native
from inferflow_tpu.quant.codec_jax import Int8MXUTensor as JI8
from inferflow_tpu.quant.codec_jax import QuantizedTensor as JQT
from inferflow_tpu_torch.loaders import model_loader as tml
from inferflow_tpu_torch.loaders.synthetic import (llama_config,
                                                   write_llama_checkpoint)
from inferflow_tpu_torch.models.spec import ModelSpec as TSpec
from inferflow_tpu_torch.quant import codec_torch
from inferflow_tpu_torch.quant.formats import FORMATS

# test-llama's shape: E 256, F 512, 2 layers, 8 heads, 2 KV heads, V 512
CONFIG = llama_config(256, 512, 2, 8, 2, 512, context=256)
LOADED_FORMATS = ("Q4_B64T1", "Q4_B32T1A", "Q8_B32T1")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The checkpoint directory (five shards and their index)."""
    d = str(tmp_path_factory.mktemp("llama_ckpt"))
    out = write_llama_checkpoint(d, CONFIG, seed=7, shard_bytes=700_000,
                                 device="cpu")
    assert len(out["files"]) == 5
    return d


def _specs(**kw):
    common = dict(model_files=["model.safetensors.index.json"],
                  model_file_format="safetensors", tensor_quant_threshold=0,
                  network_structure="transformer.llama", **kw)
    return JSpec(**common), TSpec(**common)


def _rows(t, n):
    return np.asarray(t)[:n]


def _compare(j, t):
    """One loaded leaf: the port's equals JAX's (up to JAX's pad rows)."""
    if isinstance(j, JQT):
        assert isinstance(t, codec_torch.QuantizedTensor)
        assert t.format == j.format and tuple(t.shape) == tuple(j.shape)
        assert sorted(t.planes) == sorted(j.planes)
        for name, plane in t.planes.items():
            np.testing.assert_array_equal(
                plane.numpy(), _rows(j.planes[name], plane.shape[0]))
        for a, b in ((t.scale, j.scale), (t.base, j.base)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(),
                                              _rows(b, a.shape[0]))
    elif isinstance(j, JI8):
        assert isinstance(t, codec_torch.Int8MXUTensor)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    else:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def _walk(j, t):
    if isinstance(j, dict):
        assert sorted(j) == sorted(t)
        for k in j:
            _walk(j[k], t[k])
    elif isinstance(j, list):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _walk(a, b)
    else:
        _compare(j, t)


@pytest.mark.parametrize("layout", ["packed", "i4", "i8mm"])
def test_load_model_matches_jax(ckpt, layout):
    """Q4_B64T1, Q4_B32T1A and Q8_B32T1 in the layout: every leaf equal
    (the i4 layout re-stores the 4-bit formats as data_i4p and leaves Q8 in
    its wire plane; i8mm requantizes every weight, the lm_head included,
    into the per-column int8 container); the hyperparameters come from
    config.json alike."""
    for fmt in LOADED_FORMATS:
        spec_j, spec_t = _specs(device_weight_data_type=fmt,
                                device_layout=layout)
        params_j = jml.load_model(spec_j, ckpt)
        params_t = tml.load_model(spec_t, ckpt, device="cpu")
        assert dataclasses.asdict(spec_t.hyper_params) == \
            dataclasses.asdict(spec_j.hyper_params)
        assert spec_t.hyper_params.embd_dims == CONFIG["hidden_size"]
        _walk(params_j, params_t)
        wq = params_t["layers"][0]["attn"]["wq"]
        if layout == "i8mm":
            assert isinstance(wq, codec_torch.Int8MXUTensor)
        else:
            assert set(wq.planes) == ({"data_i4p"} if layout == "i4"
                                      and fmt != "Q8_B32T1" else {"data"})


def test_quantize_matches_native_codec():
    """codec_torch.quantize gives the native codec's bytes (what the JAX
    loader quantizes with) for every block format, on f16-rounded weights
    as the loaders round them (Q3H as the pair8 plane, which the JAX
    package re-packs the native wire planes into).  Where the native
    library cannot be built, codec_native.quantize is its numpy fallback,
    which tests/test_native_codec.py holds byte-equal to it."""
    rng = np.random.default_rng(3)
    for fmt in sorted(FORMATS):
        scale = 0.25 if FORMATS[fmt].meta == "u8" else 1.0
        x = (rng.standard_normal((256, 96)) * scale).astype(
            np.float16).astype(np.float32)
        x[:64, :8] = 0.0  # all-zero blocks
        ref = codec_native.quantize(x, fmt)
        got = codec_torch.quantize(torch.from_numpy(x), fmt)
        if "pair8" in got.planes:
            ref = JQT.from_np(ref).to_np()
        assert sorted(got.planes) == sorted(ref["planes"]), fmt
        for name, plane in got.planes.items():
            np.testing.assert_array_equal(plane.numpy(), ref["planes"][name],
                                          err_msg=fmt)
        np.testing.assert_array_equal(got.scale.numpy(), ref["scale"],
                                      err_msg=fmt)
        if ref["base"] is None:
            assert got.base is None
        else:
            np.testing.assert_array_equal(got.base.numpy(), ref["base"],
                                          err_msg=fmt)


def test_head_rules_and_refusals(ckpt, tmp_path):
    """The load-time lm_head normalization (dense and Q8) and a tied
    lm_head (no lm_head in the checkpoint) load as JAX's do; whole-tensor
    element types and delta tensors raise NotImplementedError."""
    for dtype in ("F16", "Q8_B32T1"):
        spec_j, spec_t = _specs(device_weight_data_type=dtype,
                                device_layout="packed",
                                normalize_lm_head=True)
        _walk(jml.load_model(spec_j, ckpt)["lm_head"],
              tml.load_model(spec_t, ckpt, device="cpu")["lm_head"])
        assert not spec_t.normalize_lm_head
        assert spec_t._normalize_lm_head_at_load
    tied = dict(CONFIG, tie_word_embeddings=True, num_hidden_layers=1)
    d = str(tmp_path / "tied")
    write_llama_checkpoint(d, tied, seed=2, device="cpu")
    spec_j, spec_t = _specs(device_weight_data_type="Q4_B64T1",
                            device_layout="packed")
    params_j, params_t = jml.load_model(spec_j, d), tml.load_model(
        spec_t, d, device="cpu")
    assert "lm_head" not in params_j and "lm_head" not in params_t
    _walk(params_j, params_t)
    for kw, what in (({"device_weight_data_type": "Q8_GL"}, "ROADMAP A"),
                     ({"device_weight_data_type": "Q4_B64T1",
                       "delta_tensor_ratio": 0.01}, "delta")):
        _, spec_t = _specs(**kw)
        with pytest.raises(NotImplementedError, match=what):
            tml.load_model(spec_t, d, device="cpu")
    assert os.path.isfile(os.path.join(d, "config.json"))
