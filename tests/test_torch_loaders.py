"""The port's checkpoint readers against the JAX package's, on synthetic
checkpoints written in tmp_path: safetensors (one file, BF16, sharded
through an index), torch zip and legacy pickles (and the refusal to run
code), GGUF with Q8_0 blocks, GGML, llama2.c with its tokenizer, and the
Std container both ways.

Every comparison is exact: the readers are copies (safetensors also reads
into torch tensors of the stored type, the port loader's path) and the
Std container holds the same bytes.
"""

import dataclasses
import io
import json
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from inferflow_tpu.loaders import ggml as jggml
from inferflow_tpu.loaders import gguf as jgguf
from inferflow_tpu.loaders import llama2c as jl2c
from inferflow_tpu.loaders import model_loader as jml
from inferflow_tpu.loaders import pickle_reader as jpr
from inferflow_tpu.loaders import safetensors as jst
from inferflow_tpu.loaders import std_format as jstd
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu_torch.loaders import ggml as tggml
from inferflow_tpu_torch.loaders import gguf as tgguf
from inferflow_tpu_torch.loaders import llama2c as tl2c
from inferflow_tpu_torch.loaders import model_loader as tml
from inferflow_tpu_torch.loaders import pickle_reader as tpr
from inferflow_tpu_torch.loaders import safetensors as tst
from inferflow_tpu_torch.loaders import std_format as tstd

from test_ggml_and_encoder_engine import _write_ggjt
from test_loaders import _write_gguf


def _fields(hp) -> dict:
    """A HyperParams as a dict (the two packages' classes differ)."""
    return dataclasses.asdict(hp)


def _same(a, b):
    """numpy or torch leaves (bf16 as float32) compared exactly."""
    def as_np(x):
        if isinstance(x, torch.Tensor):
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_safetensors_match_jax(tmp_path):
    """One file of every numpy type, a BF16 file written by the port (the
    JAX reader widens it, the port's torch read keeps bf16), and a sharded
    checkpoint through its index: both readers and both loaders' streams
    give the same tensors."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "m.safetensors")
    tensors = {"a": rng.standard_normal((4, 8)).astype(np.float32),
               "b": rng.standard_normal((3,)).astype(np.float16),
               "c": rng.integers(-9, 9, (2, 5)).astype(np.int32),
               "d": rng.integers(0, 255, (7,)).astype(np.uint8)}
    jst.save_safetensors(path, tensors, {"format": "test"})
    bf = torch.from_numpy(rng.standard_normal((5, 6)).astype(
        np.float32)).to(torch.bfloat16)
    bpath = str(tmp_path / "bf.safetensors")
    tst.save_safetensors(bpath, {"w": bf})
    for p in (path, bpath):
        sj, st = jst.SafetensorsFile(p), tst.SafetensorsFile(p)
        assert sj.names() == st.names() and sj.metadata == st.metadata
        for name in sj.names():
            _same(st.tensor(name), sj.tensor(name))
            got = st.torch_tensor(name)
            if name == "w":
                assert got.dtype == torch.bfloat16 and torch.equal(got, bf)
            _same(got.float().numpy().astype(sj.tensor(name).dtype),
                  sj.tensor(name))
        sj.close()
        st.close()
    # sharded: two shards and an index; the loaders stream the same tensors
    tst.save_safetensors(str(tmp_path / "s1.safetensors"), {"x": bf})
    jst.save_safetensors(str(tmp_path / "s2.safetensors"),
                         {"y": tensors["a"]})
    ipath = str(tmp_path / "model.safetensors.index.json")
    with open(ipath, "w") as fh:
        json.dump({"weight_map": {"x": "s1.safetensors",
                                  "y": "s2.safetensors"}}, fh)
    assert tst.resolve_index(ipath) == jst.resolve_index(ipath)
    assert tml.detect_format(ipath) == jml.detect_format(ipath)
    got = dict(tml.iter_checkpoint_tensors([ipath], "safetensors"))
    ref = dict(jml.iter_checkpoint_tensors([ipath], "safetensors"))
    assert sorted(got) == sorted(ref) == ["x", "y"]
    for name in ref:
        _same(got[name].float().numpy(), ref[name])


def test_torch_pickles_match_jax_and_refuse_code(tmp_path):
    """torch zip (float32, float16, bf16) and legacy checkpoints read alike
    by both safe readers, and through both loaders' streams; a pickle that
    would run os.system is refused by both."""
    rng = np.random.default_rng(1)
    sd = {"model.layers.0.self_attn.q_proj.weight":
          torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
          "model.embed_tokens.weight":
          torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float16)),
          "model.norm.weight":
          torch.from_numpy(rng.standard_normal((8,)).astype(
              np.float32)).to(torch.bfloat16)}
    zpath, lpath = str(tmp_path / "ckpt.bin"), str(tmp_path / "legacy.pt")
    torch.save(sd, zpath)
    torch.save(sd, lpath, _use_new_zipfile_serialization=False)
    for path in (zpath, lpath):
        assert tml.detect_format(path) == jml.detect_format(path) == "pickle"
        got, ref = tpr.load_torch_checkpoint(path), \
            jpr.load_torch_checkpoint(path)
        assert sorted(got) == sorted(ref) == sorted(sd)
        for name in sd:
            _same(got[name], ref[name])
            np.testing.assert_array_equal(ref[name], sd[name].float().numpy()
                                          .astype(ref[name].dtype))
        stream = dict(tml.iter_checkpoint_tensors([path], "pickle"))
        for name in sd:
            _same(stream[name].numpy(), ref[name])

    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    payload = pickle.dumps(Evil())
    for mod in (tpr, jpr):
        with pytest.raises(mod.UnpicklingError):
            mod.SafeUnpickler(io.BytesIO(payload)).load()


def _write_gguf_q8(path, rng):
    """A GGUF v3 file with one Q8_0 tensor of 2 x 64 (4 blocks) and one
    float32 tensor."""
    def s(txt):
        b = txt.encode()
        return struct.pack("<Q", len(b)) + b

    blocks = b"".join(np.float16(rng.uniform(0.01, 0.1)).tobytes()
                      + rng.integers(-128, 127, 32).astype(np.int8).tobytes()
                      for _ in range(4))
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    buf = bytearray(b"GGUF" + struct.pack("<I", 3))
    buf += struct.pack("<Q", 2) + struct.pack("<Q", 0)
    buf += s("q") + struct.pack("<I", 2) + struct.pack("<QQ", 64, 2)
    buf += struct.pack("<I", 8) + struct.pack("<Q", 0)  # Q8_0
    buf += s("f") + struct.pack("<I", 2) + struct.pack("<QQ", 4, 3)
    buf += struct.pack("<I", 0) + struct.pack("<Q", 160)
    buf += b"\0" * ((-len(buf)) % 32)
    buf += blocks + b"\0" * (160 - len(blocks)) + f32.tobytes()
    with open(path, "wb") as fh:
        fh.write(buf)


def test_gguf_ggml_llama2c_match_jax(tmp_path):
    """GGUF (dense, Q8_0 blocks, the vocab), GGML (GGJT) and a llama2.c
    checkpoint with its tokenizer.bin: the port's readers equal JAX's."""
    rng = np.random.default_rng(2)
    gpath = str(tmp_path / "m.gguf")
    _write_gguf(gpath, {"x": rng.standard_normal((4, 8)).astype(np.float32),
                        "y": rng.standard_normal((2, 6)).astype(np.float16)},
                {"general.alignment": 32, "tokenizer.ggml.model": "llama",
                 "tokenizer.ggml.tokens": ["<s>", "</s>", "a", "b"],
                 "tokenizer.ggml.bos_token_id": 0})
    qpath = str(tmp_path / "q8.gguf")
    _write_gguf_q8(qpath, rng)
    for path, names in ((gpath, ("x", "y")), (qpath, ("q", "f"))):
        gj, gt = jgguf.GGUFFile(path), tgguf.GGUFFile(path)
        assert gj.names() == gt.names() == list(names)
        for name in names:
            _same(gt.tensor(name), gj.tensor(name))
        assert gt.vocab() == gj.vocab()
        gj.close()
        gt.close()
    mpath = str(tmp_path / "model.ggml.bin")
    _write_ggjt(mpath, {"w": rng.standard_normal((3, 5)).astype(np.float32)},
                [(b"<s>", 0.0), (b"hi", -1.5)])
    fj, ft = jggml.GGMLFile(mpath), tggml.GGMLFile(mpath)
    assert fj.names() == ft.names()
    for name in fj.names():
        _same(ft.tensor(name), fj.tensor(name))
    fj.close()
    ft.close()
    # llama2.c: 7 int32 hyperparameters, then float32 tensors; tokenizer.bin
    dim, hid, lay, heads, vocab, seq = 32, 64, 1, 4, 12, 16
    cpath = str(tmp_path / "stories.bin")
    with open(cpath, "wb") as fh:
        fh.write(struct.pack("<7i", dim, hid, lay, heads, heads, vocab, seq))
        for shape in ((vocab, dim), (dim,), (dim, dim), (dim, dim),
                      (dim, dim), (dim, dim), (dim,), (hid, dim), (dim, hid),
                      (hid, dim), (dim,), (seq, dim // heads)):
            fh.write(rng.standard_normal(shape).astype(np.float32).tobytes())
    tpath = str(tmp_path / "tokenizer.bin")
    with open(tpath, "wb") as fh:
        fh.write(struct.pack("<i", 8))
        for i in range(vocab):
            piece = f"t{i}".encode()
            fh.write(struct.pack("<fi", -float(i), len(piece)) + piece)
    assert tml.detect_format(cpath) == jml.detect_format(cpath) == "llama2.c"
    (spec_t, raw_t), (spec_j, raw_j) = (tl2c.load_llama2c_checkpoint(cpath),
                                        jl2c.load_llama2c_checkpoint(cpath))
    assert _fields(spec_t.hyper_params) == _fields(spec_j.hyper_params)

    def walk(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            _same(a, b)

    walk(raw_t, raw_j)
    vt, vj = (tl2c.load_llama2c_tokenizer(tpath, vocab),
              jl2c.load_llama2c_tokenizer(tpath, vocab))
    assert [(t.str, t.score) for t in vt.tokens] == [
        (t.str, t.score) for t in vj.tokens]


def test_std_format_round_trip(tmp_path):
    """A Std file written by either package loads in the other with the
    same leaves: test-llama's per-layer params from Q4_B64T1 (wire planes)
    and from Q3H_B64T1 (pair8) beside dense bf16 leaves."""
    for fmt in ("Q4_B64T1", "Q3H_B64T1"):
        spec_j = jzoo.make_spec("test-llama", layers=1)
        spec_j.tensor_quant_threshold = 0
        params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=1,
                                              stacked=False,
                                              device_layout="packed")
        jpath = str(tmp_path / f"j_{fmt}.std.safetensors")
        jstd.save_std(jpath, spec_j, params_j)
        spec_t, params_t = tstd.load_std(jpath, device="cpu")
        assert _fields(spec_t.hyper_params) == _fields(spec_j.hyper_params)
        tpath = str(tmp_path / f"t_{fmt}.std.safetensors")
        tstd.save_std(tpath, spec_t, params_t)
        spec_back, params_back = jstd.load_std(tpath)
        assert _fields(spec_back.hyper_params) == _fields(spec_j.hyper_params)
        spec_self, params_self = tstd.load_std(tpath, device="cpu")

        def walk(j, t, back, own):
            if isinstance(j, dict) and not hasattr(j, "planes"):
                for k in j:
                    walk(j[k], t[k], back[k], own[k])
            elif isinstance(j, list):
                for args in zip(j, t, back, own):
                    walk(*args)
            elif hasattr(j, "planes"):
                for q in (t, back, own):
                    assert q.format == j.format
                    assert tuple(q.shape) == tuple(j.shape)
                    assert sorted(q.planes) == sorted(j.planes)
                    for k in j.planes:
                        _same(np.asarray(q.planes[k]) if not isinstance(
                            q.planes[k], torch.Tensor) else q.planes[k],
                            np.asarray(j.planes[k]))
                    for a, b in ((q.scale, j.scale), (q.base, j.base)):
                        _same(a if isinstance(a, torch.Tensor)
                              else np.asarray(a), np.asarray(b))
            else:
                ref = np.asarray(j, np.float32)
                for q in (t, own):
                    assert q.dtype == torch.bfloat16
                    _same(q.float().numpy(), ref)
                _same(np.asarray(back, np.float32), ref)

        walk(params_j, params_t, params_back, params_self)
