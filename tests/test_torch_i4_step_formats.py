"""B4 mode (b)'s plain step on the 4-bit formats with f16 metadata beside
Q4_B64T1 (Q4_B32T1A and Q4_B32T1B) against the JAX package's
``fused_decode_step(interpret=True)`` pinned to i4x8
(INFERFLOW_I4_DOT=i8), on the CPU.  The formats with f32 metadata
(Q4_B32T2, Q4_B16) follow the codec instead (ROADMAP C7):
tests/test_torch_i4_formats.py holds them.

Tolerances, as tests/test_torch_i4.py states them for Q4_B64T1:
STEP_TOL_B1 at B = 1 and STEP_TOL at B = 4 on the hidden state and on the
appended K/V rows (the same int8 codes and exact block dots on both sides;
float32 summation orders and the batched mode's bf16 roundings differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu.models import decoder as jdec
from inferflow_tpu.models import zoo as jzoo
from inferflow_tpu.runtime import kv_cache as jkv
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.models import decoder as tdec
from inferflow_tpu_torch.models import zoo as tzoo
from inferflow_tpu_torch.weights import params_from_numpy

from test_torch_decode_step import _caches, _grab_rows
from test_torch_decoder import jax_params_to_numpy

STEP_TOL = 6e-2
STEP_TOL_B1 = 1e-2


# one narrow test-llama layer (D = 32): the interpreter's steps stay short
NARROW = dict(layers=1, embd=128, heads=4, kv_heads=2, inter=256, vocab=256)


def _models(fmt):
    spec_j = jzoo.make_spec("test-llama", device_layout="i4", **NARROW)
    params_j = jzoo.make_synthetic_params(spec_j, fmt, seed=3, stacked=True,
                                          device_layout="i4")
    spec_t = tzoo.make_spec("test-llama", device_layout="i4", **NARROW)
    params_t = params_from_numpy(jax_params_to_numpy(params_j), spec_t,
                                 device="cpu")
    return spec_j, params_j, spec_t, params_t


def test_fused_step_f16_formats_match_jax(monkeypatch):
    """B4 mode (b)'s plain step on Q4_B32T1A and Q4_B32T1B against JAX
    fused_decode_step(interpret=True) pinned to i4x8, one narrow layer
    (NARROW): B = 4, one slot inactive and one at the last cache row
    (Q4_B32T1A), and B = 1 (Q4_B32T1B)."""
    monkeypatch.setenv("INFERFLOW_I4_DOT", "i8")
    rows_j = _grab_rows(jkv, monkeypatch)
    rows_t = _grab_rows(tds, monkeypatch)
    for fmt, cases in (
            ("Q4_B32T1A", (([200, 0, 511, 17], 5, STEP_TOL),)),
            ("Q4_B32T1B", (([300], 4, STEP_TOL_B1),))):
        spec_j, params_j, spec_t, params_t = _models(fmt)
        hp = spec_t.hyper_params

        @jax.jit
        def step_j(layers, x, pos, cache):
            out = jds.fused_decode_step(spec_j, layers, x, pos, cache,
                                        interpret=True)
            return out, rows_j["k"], rows_j["v"]

        for lengths, seed, tol in cases:
            jc, tc = _caches(spec_j, spec_t, lengths, seed)
            b = len(lengths)
            assert jds.fused_step_preferred(spec_j, params_j["layers"], jc, b)
            assert tds.fused_step_preferred(spec_t, params_t["layers"], tc, b)
            tokens = np.random.default_rng(seed).integers(
                0, hp.vocab_size, (b, 1)).astype(np.int32)
            pos = np.asarray(lengths, np.int32)[:, None]
            xj = jdec.embed_tokens(spec_j, params_j, jnp.asarray(tokens),
                                   jnp.asarray(pos))
            xt = tdec.embed_tokens(spec_t, params_t, torch.from_numpy(tokens),
                                   torch.from_numpy(pos))
            (ref, jc), kj, vj = step_j(params_j["layers"], xj,
                                       jnp.asarray(pos), jc)
            got, tc = tds.fused_decode_step(spec_t, params_t["layers"], xt,
                                            torch.from_numpy(pos), tc)
            ref = np.asarray(ref, np.float32)
            assert got.shape == ref.shape == (b, 1, hp.embd_dims)
            assert np.abs(got.float().numpy() - ref).max() <= tol, (fmt, b)
            for name, r in (("k", kj), ("v", vj)):
                assert np.abs(rows_t[name].numpy()
                              - np.asarray(r)).max() <= tol, (fmt, b, name)
