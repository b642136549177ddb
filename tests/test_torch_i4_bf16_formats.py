"""B4 mode (b')'s plain step on the 32-row 4-bit formats with f16 metadata
(Q4_B32T1A and Q4_B32T1B) against the JAX package's
``fused_decode_step(interpret=True)`` under INFERFLOW_I4_DOT=bf16, on the
CPU, one narrow test-llama layer each: Q4_B32T1A at B = 4 (one slot
inactive, one at the last cache row) and Q4_B32T1B at B = 1.  The
tolerances and the check are tests/test_torch_i4_bf16.py's
(``check_step_against_jax``); Q4_B64T1 and the f32-metadata formats are
held there.
"""

from test_torch_i4_bf16 import NARROW, _models, check_step_against_jax


def test_fused_step_b32_formats_match_jax(monkeypatch):
    for fmt, runs in (("Q4_B32T1A", (([200, 0, 511, 17], 5),)),
                      ("Q4_B32T1B", (([300], 4),))):
        check_step_against_jax(monkeypatch, _models(fmt, **NARROW), runs)
