"""Smoke run of inferflow_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``inferflow_tpu_torch/kernels/csrc`` (one nvcc
per source, all at once, into ``build/inferflow_tpu_torch/``), then:

1. prints the card (torch's name; nvidia-smi's name and power limit);
2. holds each kernel against its plain PyTorch version at the shapes the
   serving path gives it (B1 dequant-matmul: M in {1, 4, 256} for the five
   tinyllama-1.1b projections; B2 decode attention: 4 slots, 1024-row
   context, layer 21; B3 chunk attention: a 256-row chunk at row 256) and
   times kernel, plain version and one PyTorch library call (cuBLAS matmul
   on the pre-dequantized weight, scaled_dot_product_attention on
   pre-dequantized K/V; timed here only, never used by the package), with
   the L2 cache flushed before every timed launch; one JSON line each;
3. serves four greedy queries (prompts of 7, 60, 200 and 300 tokens, 16
   new tokens each; the 300-token prompt takes the chunked path) with the
   engine at full tinyllama-1.1b width (seed-0 synthetic Q4_B64T1 weights,
   packed wire layout, Q8 KV cache, 4 slots, 1024-token context), counts
   each kernel's launches in that run and requires all three > 0, reads
   the device memory of the weights and its peaks while building them and
   while serving, profiles
   three decode steps of one more query (device busy and idle share, the
   device time by kernel), and holds every served logits row (each prefill
   and each decode step of the four queries) against the same engine on
   the CPU (plain versions), run in the same interleaving and fed the
   tokens the card served.

Exits non-zero if any check fails.  The last line is the device record
``{"ok": true, "device": {...}}``; the line before it holds the kernel
summary ``{"kernels": [...]}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
KERNEL_REL_TOL = 8e-3  # |kernel - plain| <= tol * max|plain|: ~2 bf16 ulps
TIMED_ITERS = 20
MODEL = "tinyllama-1.1b"
PROMPT_LENS = (7, 60, 200, 300)
MAX_NEW = 16
SLOTS, CONTEXT = 4, 1024
# every served logits row on the card against the CPU engine fed the same
# tokens: kernel and plain version differ only in summation order, and the
# bf16 roundings this moves grow through 22 layers (first rows measured
# 0.022-0.035 on an H100); the gate is about twice that, under 4% of the
# largest logit (~2.2)
ENGINE_LOGIT_TOL = 0.08

KERNEL_SOURCES = {
    "dequant_matmul": ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
                       "inferflow_tpu/kernels/dequant_matmul.py:146"),
    "decode_attention": ("inferflow_tpu_torch/kernels/csrc/attention.cu",
                         "inferflow_tpu/kernels/attention.py:68"),
    "chunk_attention": ("inferflow_tpu_torch/kernels/csrc/attention.cu",
                        "inferflow_tpu/kernels/attention.py:507"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Median device time of a callable over TIMED_ITERS launches, each
    after an L2 flush, measured with CUDA events.

    The flush READS 128 MiB (a write would leave 50 MB of dirty lines whose
    write-back the timed kernel would pay for).  A device sleep is queued
    first, so the host enqueues every launch before the device reaches it:
    the events then time the device work, not the host's Python between
    two events.  An event behind the sleep proves it: if the device has
    passed it by the time the last launch is queued, the host fell behind,
    and the measurement is repeated with a four times longer sleep."""

    SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's ~2 GHz clock

    def __init__(self, device):
        self.flush_buf = torch.ones(32 * 1024 * 1024, dtype=torch.int32,
                                    device=device)

    def __call__(self, fn) -> float:
        fn()  # warm up
        torch.cuda.synchronize()
        for attempt in range(4):
            torch.cuda._sleep(self.SLEEP_CYCLES * 4 ** attempt)
            gate = torch.cuda.Event()
            gate.record()
            pairs = []
            for _ in range(TIMED_ITERS):
                self.flush_buf.max()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            host_ahead = not gate.query()
            torch.cuda.synchronize()
            if host_ahead:
                return float(np.median([s.elapsed_time(e) for s, e in pairs]))
        raise RuntimeError("the host could not queue the timed launches "
                           "ahead of the device")


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = bool(np.isfinite(err) and err <= KERNEL_REL_TOL * scale + 1e-6)
    return {"max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tolerance": f"max_abs_err <= {KERNEL_REL_TOL} * max|plain|",
            "ok": ok}


def phase_b1(timer, dev, spec) -> list:
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import dequantize, quantize
    hp = spec.hyper_params
    e, inter = hp.embd_dims, hp.decoder_intermediate_size
    q_dim = hp.decoder_heads * hp.head_dim
    kv_dim = hp.kv_heads * hp.head_dim
    shapes = {"qkv": (e, q_dim + 2 * kv_dim), "wo": (q_dim, e),
              "w1n3": (e, 2 * inter), "w2": (inter, e),
              "lm_head": (e, hp.vocab_size)}
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
        qt = quantize(w, "Q4_B64T1")
        w_bf16 = dequantize(qt, torch.bfloat16)
        for m in (1, 4, 256):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = quantized_matmul(x, qt)
            ref = quantized_matmul_plain(x, qt)
            torch.cuda.synchronize()
            res = compare(got, ref)
            bytes_moved = 2 * m * k + k * n // 2 + 4 * (k // 64) * n \
                + 2 * m * n
            b_ms, b_by = bound(bytes_moved, 2 * m * k * n)
            row = {"phase": "kernel", "kernel": "dequant_matmul",
                   "shape": f"{name} M={m} K={k} N={n}", **res,
                   "ms": timer(lambda: quantized_matmul(x, qt)),
                   "plain_ms": timer(lambda: quantized_matmul_plain(x, qt)),
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def _filled_cache(dev, spec, batch, rows, seed):
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    hp = spec.hyper_params
    cache = KVCache.create(hp.decoder_layers, batch, CONTEXT, hp.kv_heads,
                           hp.head_dim, quantized=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for layer in range(hp.decoder_layers):
        k = torch.randn((batch, rows, hp.kv_heads, hp.head_dim),
                        generator=gen, device=dev)
        v = torch.randn((batch, rows, hp.kv_heads, hp.head_dim),
                        generator=gen, device=dev)
        cache.update_layer(layer, k, v, torch.zeros(batch, dtype=torch.int32,
                                                    device=dev))
    return cache, gen


def _kv_bytes(rows: int, spec) -> int:
    """Q8 K and V rows with their f16 scales (one per 32 elements)."""
    hp = spec.hyper_params
    per_row = hp.kv_heads * (hp.head_dim + 2 * (hp.head_dim // 32))
    return 2 * rows * per_row


def _expand_heads(t, g):
    return t.repeat_interleave(g, dim=1)


def phase_b2(timer, dev, spec) -> list:
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.attention import (
        decode_attention, decode_attention_plain)
    hp = spec.hyper_params
    b, layer, d = SLOTS, hp.decoder_layers - 1, hp.head_dim
    g = hp.decoder_heads // hp.kv_heads
    cache, gen = _filled_cache(dev, spec, b, CONTEXT, seed=2)
    lengths = torch.tensor([CONTEXT, 700, 301, 17], dtype=torch.int32,
                           device=dev)
    q = (torch.randn((b, 1, hp.decoder_heads, d), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    got, _ = decode_attention(q, cache, layer, lengths)
    ref = decode_attention_plain(q[:, 0], cache, layer, lengths)
    torch.cuda.synchronize()
    res = compare(got[:, 0], ref)
    k, v = cache.read_layer(layer, torch.bfloat16)  # (B, S, H, D)
    k = _expand_heads(k.transpose(1, 2), g)
    v = _expand_heads(v.transpose(1, 2), g)
    mask = (torch.arange(CONTEXT, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)  # (B, Hq, 1, D)
    live = int(lengths.sum().item())
    bytes_moved = _kv_bytes(live, spec) + 2 * 2 * q.numel() + 4 * b
    flops = 4 * live * hp.decoder_heads * d
    b_ms, b_by = bound(bytes_moved, flops)
    row = {"phase": "kernel", "kernel": "decode_attention",
           "shape": f"B={b} Hq={hp.decoder_heads} H={hp.kv_heads} D={d} "
                    f"S={CONTEXT} lengths={lengths.tolist()} layer={layer}",
           **res,
           "ms": timer(lambda: decode_attention(q, cache, layer, lengths)),
           "plain_ms": timer(lambda: decode_attention_plain(
               q[:, 0], cache, layer, lengths)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qs, k, v, attn_mask=mask)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return [row]


def phase_b3(timer, dev, spec) -> list:
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.attention import (
        chunk_attention, chunk_attention_plain)
    hp = spec.hyper_params
    c, start, slot, layer, d = 256, 256, 1, hp.decoder_layers - 1, \
        hp.head_dim
    g = hp.decoder_heads // hp.kv_heads
    cache, gen = _filled_cache(dev, spec, 2, start + c, seed=3)
    q = (torch.randn((1, c, hp.decoder_heads, d), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    got, _ = chunk_attention(q, cache, layer, slot, start)
    ref = chunk_attention_plain(q[0], cache, layer, slot, start)
    torch.cuda.synchronize()
    res = compare(got[0], ref)
    n_keys = start + c
    k, v = cache.read_layer(layer, torch.bfloat16)
    k = _expand_heads(k[slot:slot + 1, :n_keys].transpose(1, 2), g)
    v = _expand_heads(v[slot:slot + 1, :n_keys].transpose(1, 2), g)
    mask = (torch.arange(n_keys, device=dev)[None, :]
            <= start + torch.arange(c, device=dev)[:, None])
    qs = q.transpose(1, 2)  # (1, Hq, C, D)
    visible = sum(start + i + 1 for i in range(c))
    bytes_moved = _kv_bytes(n_keys, spec) + 2 * 2 * q.numel()
    flops = 4 * visible * hp.decoder_heads * d
    b_ms, b_by = bound(bytes_moved, flops)
    row = {"phase": "kernel", "kernel": "chunk_attention",
           "shape": f"C={c} start={start} Hq={hp.decoder_heads} "
                    f"H={hp.kv_heads} D={d} layer={layer}",
           **res,
           "ms": timer(lambda: chunk_attention(q, cache, layer, slot,
                                               start)),
           "plain_ms": timer(lambda: chunk_attention_plain(
               q[0], cache, layer, slot, start)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qs, k, v, attn_mask=mask)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return [row]


def _record_rows(eng, forced=None) -> dict:
    """Keep every logits row the engine samples from, per query id.  With
    `forced` ({query id: tokens}) the i-th sample of a query returns
    forced[qid][i] in place of the sampler's choice: a reference engine fed
    the tokens another engine served."""
    rows = {}
    choose = eng.strategies.choose_token

    def recording(qid, logits, prev=()):
        seen = rows.setdefault(qid, [])
        seen.append(np.asarray(logits, np.float32).copy())
        tok = choose(qid, logits, prev)
        return tok if forced is None else forced[qid][len(seen) - 1]

    eng.strategies.choose_token = recording
    return rows


def _serve(eng, prompts, max_new) -> tuple:
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    qids = [eng.add_query(p, SamplingOptions(strategy="greedy"), max_new)
            for p in prompts]
    assert all(q > 0 for q in qids), qids
    prefill_ms, decode_ms, steps = [], [], 0
    while eng.has_work():
        eng.perf_stat.clear()
        eng.commit_inference_result(eng.infer())
        steps += 1
        if "prefill_ms" in eng.perf_stat:
            prefill_ms.append(eng.perf_stat["prefill_ms"])
        if "decode_ms" in eng.perf_stat:
            decode_ms.append(eng.perf_stat["decode_ms"])
        assert steps < 200, "engine did not finish"
    return qids, prefill_ms, decode_ms, steps


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def profile_decode(eng, prompt, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over `steps` decode
    steps of one query (after its prefill and one warm step); the device's
    busy time is the sum of its kernels' times (one stream: they do not
    overlap), the rest of the wall time it idles.  Only device events
    count: a host op's "self device time" is its kernels' time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    eng.add_query(prompt, SamplingOptions(strategy="greedy"), steps + 2)
    for _ in range(2):
        eng.commit_inference_result(eng.infer())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.commit_inference_result(eng.infer())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert not eng.has_work()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:10]
    emit({"phase": "decode_profile", "decode_steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": (busy_ms / steps) if busy_ms
          else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
          else "not measured",
          "device_kernels": [{"name": e.key[:80], "count": e.count // steps,
                              "ms_per_step": _device_us(e) / 1e3 / steps}
                             for e in top]})


def phase_engine(dev, spec) -> dict:
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.models.zoo import make_synthetic_params
    from inferflow_tpu_torch.runtime.engine import InferenceEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = make_synthetic_params(spec, "Q4_B64T1", seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # device memory above what the kernel phases left: resident weights,
    # the peak while building them (float32 draws, quantizer temporaries),
    # and the peak while serving (weights, cache, activations)
    memory = {"weights": torch.cuda.memory_allocated(dev) - mem_before,
              "build_peak": torch.cuda.max_memory_allocated(dev) - mem_before}
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, spec.hyper_params.vocab_size,
                                             n)] for n in PROMPT_LENS]
    eng = InferenceEngine(spec, params, max_concurrent_queries=SLOTS,
                          max_context_len=CONTEXT, kv_cache_quantized=True,
                          device=dev)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    memory["serving_peak"] = torch.cuda.max_memory_allocated(dev) - mem_before
    outputs = [eng.query_tokens(q) for q in qids]
    served = sum(len(o) for o in outputs)
    vocab = spec.hyper_params.vocab_size
    for o in outputs:
        assert len(o) == MAX_NEW and all(0 <= t < vocab for t in o), o
    for q in qids:
        assert all(np.isfinite(r).all() and r.shape == (vocab,)
                   for r in rows[q])
    emit({"phase": "engine", "model": MODEL, "slots": SLOTS,
          "context": CONTEXT, "prompt_lens": list(PROMPT_LENS),
          "tokens_served": served, "engine_steps": steps,
          "wall_s": wall_s, "param_build_s": build_s,
          "device_bytes": memory,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0) for k in KERNEL_SOURCES}})
    for k in KERNEL_SOURCES:
        assert launches.get(k, 0) > 0, f"{k} never launched in the engine run"
    profile_decode(eng, prompts[1])

    check_against_cpu(spec, params, prompts, qids, rows, outputs)
    return launches


def check_against_cpu(spec, params, prompts, qids, rows, outputs) -> None:
    """The same model and queries served on the CPU (the plain versions),
    in the same interleaving and fed the tokens the card served: every
    sampled row (each prefill and each decode step of every query) is held
    against the card's within ENGINE_LOGIT_TOL."""
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    t0 = time.perf_counter()
    cpu = InferenceEngine(spec, params, max_concurrent_queries=SLOTS,
                          max_context_len=CONTEXT, kv_cache_quantized=True,
                          device="cpu")
    cpu_rows = _record_rows(cpu, forced=dict(zip(qids, outputs)))
    ref_qids, _, _, _ = _serve(cpu, prompts, MAX_NEW)
    assert ref_qids == qids, (ref_qids, qids)
    report = {"phase": "engine_vs_cpu",
              "cpu_reference_s": time.perf_counter() - t0,
              "tolerance": f"every sampled row: max_abs_err <= "
                           f"{ENGINE_LOGIT_TOL}"}
    ok = True
    for q, n, served in zip(qids, PROMPT_LENS, outputs):
        card, ref = rows[q], cpu_rows[q]
        assert len(card) == len(ref) == len(served) == MAX_NEW, q
        assert [int(r.argmax()) for r in card] == served, "not greedy"
        errs = [float(np.abs(a - b).max()) for a, b in zip(card, ref)]
        report[f"prompt_{n}"] = {
            "rows": len(errs), "max_abs_err": max(errs),
            "worst_row": int(np.argmax(errs)), "first_row_err": errs[0],
            "max_abs_logit": float(max(np.abs(b).max() for b in ref)),
            "argmax_equal": sum(int(a.argmax()) == int(b.argmax())
                                for a, b in zip(card, ref))}
        ok &= max(errs) <= ENGINE_LOGIT_TOL
    emit(report)
    assert ok, "served logits disagree with the CPU reference"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "inferflow_tpu_torch"
            / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout: "
              "inferflow_tpu_torch/ is not beside it", file=sys.stderr)
        return 2
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.models.zoo import make_spec

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name}")
    print(smi.splitlines()[0])
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))

    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SOURCES)})

    spec = make_spec(MODEL, device_layout="packed")
    timer = Timer(dev)
    results, failed = {}, []
    phases = [("dequant_matmul", lambda: phase_b1(timer, dev, spec)),
              ("decode_attention", lambda: phase_b2(timer, dev, spec)),
              ("chunk_attention", lambda: phase_b3(timer, dev, spec)),
              ("engine", lambda: phase_engine(dev, spec))]
    for pname, fn in phases:
        try:
            results[pname] = fn()
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(pname)
    for pname in ("dequant_matmul", "decode_attention", "chunk_attention"):
        if any(not r["ok"] for r in results.get(pname, [])):
            failed.append(pname)
    if failed:
        print(f"chip_smoke: failed phases: {sorted(set(failed))}",
              file=sys.stderr)
        return 1

    launches = results["engine"]
    b1 = next(r for r in results["dequant_matmul"]
              if r["shape"].startswith("w1n3 M=4 "))
    summary = []
    for kname, row in (("dequant_matmul", b1),
                       ("decode_attention", results["decode_attention"][0]),
                       ("chunk_attention", results["chunk_attention"][0])):
        source, replaces = KERNEL_SOURCES[kname]
        summary.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "shape": row["shape"],
                        "launches": launches[kname],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
