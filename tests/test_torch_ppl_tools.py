"""The port's perplexity, PPL-report and tokenizer-converter CLIs
(``inferflow_tpu_torch/tools/``) against the JAX package's tools, on the
CPU.

The JAX tools live in ``tools/`` (not a package): they are loaded by path.

Tolerances:
  - compute_ppl on the same logits: 1e-12 relative (the same float64
    log-sum-exp over the same float32 rows);
  - perplexity over each package's forward with the same weights
    (test-tiny, Q4_B64T1, the JAX builder's params moved over with
    ``weights.params_from_numpy``): 1e-3 relative.  The forwards differ
    by bf16 roundings (measured 3.1e-4: the JAX scanned forward and the
    port's per-layer one round the residual at other places);
  - convert_tokenizer_data: the same bytes.
"""

import importlib.util
import pathlib
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu_torch.loaders.llama2c import load_llama2c_tokenizer
from inferflow_tpu_torch.loaders.synthetic import write_tokenizer_json
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.tokenizer.loading import load_tokenizer_json
from inferflow_tpu_torch.tools import convert_tokenizer_data as tconv
from inferflow_tpu_torch.tools import perplexity as tperp
from inferflow_tpu_torch.tools import ppl_report as treport
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decoder import jax_params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PPL_TOL = 1e-3


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compute_ppl_matches_jax():
    """The same logits give the same PPL, stderr and per-token NLLs, with
    windows that abut, overlap or cover the corpus at once."""
    jperp = _jax_tool("perplexity")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 50, 300).tolist()
    table = rng.standard_normal((300, 50)).astype(np.float32) * 3

    def fwd(window):  # logits of a window depend on its tokens only
        return table[np.asarray(window)[0] % 300][None]

    for ml, st in ((128, 128), (128, 64), (512, 512)):
        ref = jperp.compute_ppl(fwd, tokens, ml, st, progress=False)
        got = tperp.compute_ppl(fwd, tokens, ml, st, progress=False)
        assert len(got[2]) == len(ref[2])
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-12)
        np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-12)


def test_perplexity_matches_jax_forward():
    """perplexity's forward and protocol on test-tiny's synthetic text
    against the JAX tool's compute_ppl over decoder_forward_scan with the
    same weights."""
    jperp = _jax_tool("perplexity")
    spec_j = jzoo.make_spec("test-tiny")
    params_j = jzoo.make_synthetic_params(spec_j, "Q4_B64T1", seed=0,
                                          stacked=True)
    spec_t = tzoo.make_spec("test-tiny")
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    tokens = np.random.default_rng(0).integers(
        4, spec_t.hyper_params.vocab_size - 1, size=600).tolist()

    def fwd_j(window):
        pos = jnp.arange(window.shape[1], dtype=jnp.int32)[None, :]
        logits, _ = jdec.decoder_forward_scan(spec_j, params_j,
                                              jnp.asarray(window), pos, None)
        return logits

    ref = jperp.compute_ppl(fwd_j, tokens, 256, 128, progress=False)
    got = tperp.compute_ppl(tperp.make_forward(spec_t, params_t, "cpu"),
                            tokens, 256, 128, progress=False)
    assert len(got[2]) == len(ref[2]) == 599
    assert abs(got[0] - ref[0]) <= PPL_TOL * ref[0], (got[0], ref[0])
    out = tperp.main(["--zoo", "test-tiny", "--quant", "Q4_B64T1",
                      "--synthetic-text", "--max-tokens", "300",
                      "--max-length", "128", "--stride", "128",
                      "--device", "cpu"])
    assert out["tokens"] == 300 and out["scored"] == 297  # 3 windows
    assert np.isfinite(out["ppl"]) and out["ppl"] > 1


def test_convert_tokenizer_data_matches_jax(tmp_path, monkeypatch):
    """The binary vocab of a tokenizer.json the test writes: the same
    bytes as the JAX tool's, read back by the port's llama2.c loader."""
    src = tmp_path / "tokenizer.json"
    write_tokenizer_json(str(src), 400, seed=3)
    got, ref = tmp_path / "port.bin", tmp_path / "jax.bin"
    assert tconv.main([str(src), str(got)]) == 400
    monkeypatch.setattr(sys, "argv", ["convert_tokenizer_data.py", str(src),
                                      str(ref)])
    _jax_tool("convert_tokenizer_data").main()
    assert got.read_bytes() == ref.read_bytes()
    vocab = load_tokenizer_json(str(src))
    back = load_llama2c_tokenizer(str(got), 400)
    assert struct.unpack_from("<I", got.read_bytes())[0] == max(
        len(t.str) for t in vocab.tokens)
    assert [t.str for t in back.tokens] == [t.str for t in vocab.tokens]
    assert [t.score for t in back.tokens] == pytest.approx(
        [t.score for t in vocab.tokens])


def test_ppl_report_runs(tmp_path):
    """ppl_report on test-tiny: a two-window corpus, every format row and
    the layout ladder, the report under tmp_path."""
    out = tmp_path / "report.md"
    rows = treport.main(["--model", "test-tiny", "--tokens", "128",
                         "--max-length", "64", "--stride", "64",
                         "--layouts", "Q4_B64T1+i8mm,Q4_B64T1+i4,"
                         "Q4_B64T1+q8c,Q4_B64T1+packed", "--out", str(out),
                         "--device", "cpu"])
    assert [r["format"] for r in rows][:6] == [
        "BF16", "Q8_B32T2", "Q6_B64T1", "Q4_B64T1", "Q3H_B64T1", "Q2_B32T1A"]
    assert len(rows) == 10 and all(r["scored"] == 126 for r in rows)
    assert all(np.isfinite(r["ppl"]) for r in rows)
    # the corpus is the bf16 model's own text: bf16 scores it best but for
    # noise, and 2 bits lose most
    assert rows[5]["ppl"] > rows[0]["ppl"]
    text = out.read_text()
    assert "| Q4_B64T1+i8mm |" in text and "vs Q4_B64T1" in text
