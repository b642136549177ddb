"""The port's kernel bench (inferflow_tpu_torch/tools/kernel_bench.py) on
the CPU: every part runs its plain versions (parity only, no times) at
small shapes and exits 0; a tolerance no case can meet exits non-zero.
The card's run (kernels against plain versions, with times) is
tests/test_torch_cuda_kernel_bench.py and chip_smoke.py's kernel_bench
phase."""

import json

import pytest

from inferflow_tpu_torch.tools import kernel_bench

SMALL = ["--device", "cpu", "--skip-perf", "--k", "256", "--n", "128",
         "--formats", "Q4_B64T1,Q3H_B64T1,Q8_B32T2,Q5_B32T1"]


def _rows(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_every_part_passes_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("EXP_SHAPE", "512x256")
    assert kernel_bench.main(SMALL + ["--m", "1,20", "--b6", "--unpack",
                                      "--attention", "--b3", "--i8mm",
                                      "--i4bf16", "--i4bf16-model",
                                      "test-llama", "--i4bf16-step", "1",
                                      "--b1", "--b5", "--b1-model",
                                      "test-llama"]) == 0
    rows = _rows(capsys.readouterr().out)
    kernels = {r["kernel"] for r in rows}
    assert {"dequant_matmul", "q3h_matmul", "q8_matmul", "subbyte_matmul",
            "q3h_wire_matmul", "generic_matmul", "unpack_a", "unpack_b",
            "unpack_c", "unpack_d", "unpack_e", "decode_attention",
            "decode_attention_d256", "chunk_attention", "chunk_attention_d256",
            "paged_decode_attention_d256", "i8mm_gemv", "i4bf16_gemv",
            "i4bf16_gemv_b32", "i4bf16_gemv_b32f", "i4bf16_gemv_b16f",
            "wire_gemv", "wire_gemv_b32", "wire_gemv_q2",
            "fused_decode_step_i4bf16_b32", "fused_decode_step_wire",
            "fused_decode_step_wire_b32", "fused_decode_step_wire_q2",
            "byte_gemv", "pair8_gemv", "fused_decode_step_byte",
            "fused_decode_step_pair8", "i4_matmul", "i4_matmul_b32",
            "i4_matmul_b32f", "i4_matmul_b16f", "fused_decode_step_i4bf16",
            "fused_decode_step_i4bf16_b32f",
            "fused_decode_step_i4bf16_b16f"} <= kernels
    generic = {r["shape"].split()[1] for r in rows
               if r["kernel"] == "generic_matmul"}
    assert generic == set(kernel_bench.NONPAIR_FORMATS)
    policies = {r["policy"] for r in rows if r["part"] in ("b1", "b5")}
    assert policies == {p for _, _, p in kernel_bench.B1_POLICIES} | {
        "PackedI4"}
    assert len(policies) == 14
    assert all(r["ok"] and "ms" not in r for r in rows)


def test_mega_part_on_cpu(capsys):
    """The fused step's plain version against the per-layer loop under
    INFERFLOW_MEGA=0 (restored after), on test-llama in i8mm."""
    assert kernel_bench.main(SMALL[:-2] + [
        "--formats", "Q4_B64T1", "--mega", "--mega-model", "test-llama",
        "--mega-layout", "i8mm"]) == 0
    rows = [r for r in _rows(capsys.readouterr().out) if r["part"] == "mega"]
    assert len(rows) == 2 and all(r["kv_row_norm_rmsd"] < 2e-2 for r in rows)
    # the second witness: on the CPU the fused step is its plain version;
    # each known fault reads above the limit on one of the two measures
    for r in rows:
        assert r["fused_vs_plain_step_norm_rmsd"] == 0.0
        assert r["layered_vs_plain_step_norm_rmsd"] == r["norm_rmsd"]
        assert all(max(f.values()) >= kernel_bench.MEGA_TOL
                   for f in r["fault_norm_rmsd"].values())


def test_parity_failure_exits_nonzero(capsys):
    assert kernel_bench.main(SMALL + ["--tol", "-1"]) == 1
    assert "parity FAILURES" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not take the fused"):
        kernel_bench.main(SMALL[:-2] + ["--formats", "Q4_B64T1", "--mega",
                                        "--mega-model", "test-llama",
                                        "--mega-quant", "F16"])
