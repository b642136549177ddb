"""The unpack experiments X1-X5 (inferflow_tpu_torch/tools/exp_unpack.py,
their plain versions) against the JAX experiments run_a ... run_e of
tools/exp_unpack.py, on the CPU.

The JAX tool calls ``pallas.pallas_call`` with no interpret switch: a
test-local patch runs it in interpret mode.  Inputs are made with numpy
from one seed and handed to both (x and the scales rounded to bf16 once,
so both sides read the same bits), at K = 512, N = 256 and the JAX
kernels' column tile 128 (X3's superblock 256 values).

Tolerances: X1-X4 within one bf16 step of the output's magnitude, 2^-7 *
max|ref|: both sides form the same bf16 weights (the JAX dots run in
float32 in interpret mode, the port's in float32), and only the order of
the float32 sums differs.  X5 exact: int32 sums, then one float32
multiply.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from inferflow_tpu_torch.tools import exp_unpack as tx

ROOT = pathlib.Path(__file__).resolve().parents[1]
K, N, TN, X3_BLK = 512, 256, 128, 256


@pytest.fixture(scope="module")
def jx():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_unpack", ROOT / "tools" / "exp_unpack.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def bf16(a):  # float32 values exactly representable in bf16
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    return {
        "x": bf16(rng.standard_normal((8, K))),
        "packed": rng.integers(0, 256, (K // 2, N)).astype(np.uint8),
        "codes4": rng.integers(-8, 8, (K, N)).astype(np.int8),
        "codes8": rng.integers(-127, 128, (K, N)).astype(np.int8),
        "scale": bf16(rng.uniform(0.0, 0.01, (K // 64, N))),
        "xq": rng.integers(-127, 128, (32, K)).astype(np.int8),
        "colscale": bf16(rng.uniform(0.5, 1.5, (1, N))),
    }


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))


def _jax(name, jx, inp):
    x = jnp.asarray(inp["x"]).astype(jnp.bfloat16)
    scale = jnp.asarray(inp["scale"]).astype(jnp.bfloat16)
    packed = jnp.asarray(inp["packed"])
    codes8 = jnp.asarray(inp["codes8"])
    if name == "a":
        return jx.run_a(x, packed, scale, K, N, TN)
    if name == "b":
        codes4 = jnp.asarray(inp["codes4"]).astype(jnp.int4)
        return jx.run_b(x, codes4, scale, K, N, TN)
    if name == "c":
        return jx.run_c(x, packed, scale, K, N, TN, blk=X3_BLK)
    if name == "d":
        return jx.run_d(x, codes8, scale, K, N, TN)
    return jx.run_e(jnp.asarray(inp["xq"]), codes8,
                    jnp.asarray(inp["colscale"]).astype(jnp.bfloat16),
                    K, N, TN)


def _port(name, inp):
    x = torch.from_numpy(inp["x"]).to(torch.bfloat16)
    scale = torch.from_numpy(inp["scale"]).to(torch.bfloat16)
    packed = torch.from_numpy(inp["packed"])
    codes8 = torch.from_numpy(inp["codes8"])
    if name == "a":
        return tx.run_a(x, packed, scale)
    if name == "b":
        return tx.run_b(x, tx.pack_nibbles(torch.from_numpy(inp["codes4"])),
                        scale)
    if name == "c":
        return tx.run_c(x, packed, scale, blk=X3_BLK)
    if name == "d":
        return tx.run_d(x, codes8, scale)
    return tx.run_e(torch.from_numpy(inp["xq"]), codes8,
                    torch.from_numpy(inp["colscale"]).to(torch.bfloat16))


@pytest.mark.parametrize("name", ["a", "b", "c", "d", "e"])
def test_plain_matches_jax_experiment(name, jx, inputs, interpret):
    ref = np.asarray(_jax(name, jx, inputs), np.float32)
    got = _port(name, inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    got = got.numpy()
    if name == "e":
        np.testing.assert_array_equal(got, ref)
    else:
        tol = 2.0 ** -7 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol, (name, np.abs(got - ref).max())


def test_inputs_and_bench_on_cpu():
    """mk_inputs' shapes and types (signed nibbles two per byte, low
    nibble first), and the CPU bench: every case against itself, with no
    time (times come from the card only)."""
    codes = torch.tensor([[-8, 7], [3, -1], [0, -2], [5, 6]])
    packed = tx.pack_nibbles(codes)
    assert packed.dtype == torch.uint8 and packed.tolist() == [
        [0x38, 0xF7], [0x50, 0x6E]]
    gen = torch.Generator().manual_seed(0)
    inp = tx.mk_inputs(256, 128, gen, "cpu")
    assert {k: tuple(v.shape) for k, v in inp.items()} == {
        "x": (8, 256), "packed": (128, 128), "codes4": (128, 128),
        "codes8": (256, 128), "scale": (4, 128), "xq": (32, 256),
        "colscale": (1, 128)}
    rows = tx.bench(torch.device("cpu"), ((512, 256),))
    assert [r["kernel"] for r in rows] == [
        "unpack_a", "unpack_b", "unpack_c", "unpack_d", "unpack_e"]
    assert all(r["ok"] and "ms" not in r for r in rows)
