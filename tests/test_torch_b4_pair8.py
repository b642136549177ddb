"""The fused decode step's mode (h), Q3H_B64T1 in the pair8 layout (one
byte per base-11 value pair), in the port against the JAX package, on the
CPU.

Both packages support the mode and route it to the per-layer loop unless
INFERFLOW_MEGA=2.  Weights: the JAX zoo's test-llama params (3 layers)
and test-moe params (mode (g) with pair8 experts) under
``device_layout="packed"``, moved over with ``weights.params_from_numpy``.
The JAX step runs its Pallas kernel with ``interpret=True``.

Tolerances: tests/test_torch_b4_wire.py's (the JAX package's own for its
fused step against its per-layer path: hidden norm_rmsd 3e-2, max abs
6e-2 on the hidden state and the appended rows; the interpreter keeps
each weight in float32 where the TPU and the port round it to bf16;
measured on pair8 at most 0.029 norm_rmsd, 0.043 and 0.040); mode (g):
tests/test_torch_moe.py's STEP_NRMSD = 0.01 on the hidden state
(measured 0.0048: the interpreter's float32 weights again);
engines ENGINE_LOGIT_TOL = 5e-2 on logits.
"""

import jax.numpy as jnp
import numpy as np
import torch

from inferflow_tpu.kernels import decode_step as jds
from inferflow_tpu_torch.kernels import decode_step as tds
from inferflow_tpu_torch.quant.codec_torch import PAIR8_PLANE

from test_torch_b4_wire import (CACHE_ROWS, STEP_TOL, check_engines,
                                check_step, models)
from test_torch_decode_step import _caches
from test_torch_mega_env import jax_mega  # noqa: F401 - a fixture
from test_torch_moe import STEP_NRMSD, WIDE, _models, norm_rmsd

FMT = "Q3H_B64T1"


def test_pair8_step_matches_jax(monkeypatch):
    """The plain B4 in mode (h) against JAX fused_decode_step
    (interpret=True): B = 1, B = 2 (one slot at the cache's last row) and
    B = 2 over a paged pool with shuffled pages."""
    m = models(FMT)
    w = m[3]["layers"][0]["ffn"]["w1n3"]
    assert set(w.planes) == {PAIR8_PLANE} and tds._mm_mode(w) == "pair8"
    check_step(m, [300], 4, STEP_TOL, monkeypatch)
    check_step(m, [200, CACHE_ROWS - 1], 5, STEP_TOL, monkeypatch)
    check_step(m, [700, 130], 6, STEP_TOL, monkeypatch,
               tables=([6, 2, 4], [3, 5, 0]))


def test_pair8_moe_step_matches_jax():
    """Mode (g) with pair8 experts (test-moe at the JAX kernel's lane
    width, one layer) at B = 2, against the interpreted JAX kernel."""
    spec_j, params_j, spec_t, params_t = _models(FMT, "packed", seed=2,
                                                 layers=1, **WIDE)
    hp = spec_t.hyper_params
    stack = params_t["layers"][0]["moe"]["experts_stacked"]["w1n3"]
    assert tds._mm_mode(stack) == "pair8"
    lengths = [4, 21]
    jc, tc = _caches(spec_j, spec_t, lengths, 5)
    assert jds.fused_step_supported(spec_j, params_j["layers"], jc, 2)
    assert tds.fused_step_supported(spec_t, params_t["layers"], tc, 2)
    x = (np.random.default_rng(1).standard_normal((2, 1, hp.embd_dims))
         * 0.3).astype(np.float32)
    pos = np.asarray(lengths, np.int32)[:, None]
    ref, _ = jds.fused_decode_step(
        spec_j, params_j["layers"], jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(pos), jc, interpret=True)
    got, _ = tds.fused_decode_step(spec_t, params_t["layers"],
                                   torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(pos), tc)
    err = norm_rmsd(got.float().numpy(), ref)
    assert err < STEP_NRMSD, err


def test_pair8_engine_under_mega_2_matches_jax(jax_mega, monkeypatch):
    """Q3H pair8 at 4 slots under INFERFLOW_MEGA=2: the port's every
    decode step takes mode (h), as the JAX engine's takes its fused
    step."""
    check_engines(models(FMT), monkeypatch, "pair8_matmul_plain")
