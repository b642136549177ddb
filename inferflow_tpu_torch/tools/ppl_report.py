"""Per-bit-width perplexity deltas, offline (port of tools/ppl_report.py).

No real checkpoint is at hand, so reference-against-port perplexity on a
real corpus cannot be measured.  What this report measures instead:

 1. the full PPL protocol (window/stride log-softmax NLL, perplexity.cc:
    100-157, 278-287) runs end to end on the port;
 2. per-bit-width PPL deltas on a corpus the model actually models: text
    sampled from the bf16 model itself (a random-weight model gives any
    external corpus a near-uniform PPL; its own samples have a low PPL,
    and quantization damage shows as a measurable delta).  The wire
    codecs are byte-exact against the reference's own quantizer
    (tests/golden), so at equal bit width both engines read the same
    weights.

The corpus is sampled from the bf16 model (temperature 0.9, an explicit
``torch.Generator``) in independent windows of `max_length` tokens, all
windows decoded together as one batch through a bf16 KV cache; every
format and layout is then scored on the same tokens.

Usage: python -m inferflow_tpu_torch.tools.ppl_report
       [--model tinyllama-1.1b] [--tokens 2048]
       [--layouts Q4_B64T1+i8mm,...] [--out build/ppl_report.md]
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

OUT_SCALE = 6.0


def sample_corpus(spec, params, n_windows: int, wlen: int, seed: int,
                  device) -> list:
    """n_windows independent windows of wlen tokens ([1] + wlen - 1
    sampled), decoded together through a bf16 KV cache."""
    from ..models.decoder import (decoder_layers_unrolled, embed_tokens,
                                  output_logits)
    from ..runtime.kv_cache import KVCache
    hp = spec.hyper_params
    cache = KVCache.create(hp.decoder_layers, n_windows, wlen, hp.kv_heads,
                           hp.head_dim, quantized=False, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = torch.ones((n_windows, 1), dtype=torch.long, device=device)
    out = [tok]
    with torch.no_grad():
        for _ in range(wlen - 1):
            pos = cache.length[:, None].long()
            x = embed_tokens(spec, params, tok, pos)
            x, cache = decoder_layers_unrolled(spec, params["layers"], x,
                                               pos, cache)
            logits = output_logits(spec, params, x)[:, -1]
            cache.with_length(cache.length + 1)
            probs = torch.softmax(logits / 0.9, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
            out.append(tok)
    return torch.cat(out, dim=1).reshape(-1).tolist()


def main(argv=None) -> list:
    """Sample, score and write the report; returns the rows as dicts
    {"format", "ppl", "stderr", "scored", "delta_vs_bf16"[, "vs_wire"]}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--max-length", type=int, default=512)
    ap.add_argument("--stride", type=int, default=512)
    ap.add_argument("--formats", default="BF16,Q8_B32T2,Q6_B64T1,"
                    "Q4_B64T1,Q3H_B64T1,Q2_B32T1A")
    ap.add_argument("--layouts", default="",
                    help="extra rows 'WIREFMT+LAYOUT' (e.g. "
                    "'Q4_B64T1+i8mm,Q4_B64T1+i4,Q4_B64T1+q8c,"
                    "Q4_B64T1+packed'): the device-layout ladder, scored "
                    "on the same corpus; deltas against bf16 and against "
                    "the row's wire format")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/ppl_report.md")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..models.zoo import make_spec, make_synthetic_params
    from .perplexity import compute_ppl, make_forward
    device = resolve_device(args.device)

    def spec_for(layout=""):
        kw = {"device_layout": layout} if layout else {}
        if args.layers:
            kw["layers"] = args.layers
        spec = make_spec(args.model, **kw)
        # sharpen the output distribution: a random-weight model is
        # near-uniform (PPL ~ vocab size, blind to quantization); the same
        # scale applies to generation and to every evaluation
        spec.out_scale = OUT_SCALE
        return spec

    spec = spec_for()
    gen_params = make_synthetic_params(spec, None, seed=args.seed,
                                       device=device)
    t0 = time.time()
    n_windows = max(1, args.tokens // args.max_length)
    tokens = sample_corpus(spec, gen_params, n_windows, args.max_length,
                           args.seed, device)
    del gen_params
    print(f"# corpus of {len(tokens)} tokens sampled in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)

    jobs = [(f.strip(), "") for f in args.formats.split(",") if f.strip()]
    for item in filter(None, args.layouts.split(",")):
        wf, _, layout = item.strip().partition("+")
        jobs.append((wf, layout))
    rows = []
    for fmt, layout in jobs:
        spec = spec_for(layout)
        wf = None if fmt in ("F16", "BF16") else fmt
        params = make_synthetic_params(spec, wf, seed=args.seed,
                                       device=device, device_layout=layout)
        ppl, stderr, nlls = compute_ppl(make_forward(spec, params, device),
                                        tokens, args.max_length,
                                        args.stride, progress=False)
        rows.append({"format": f"{fmt}+{layout}" if layout else fmt,
                     "ppl": ppl, "stderr": stderr, "scored": len(nlls)})
        print(json.dumps(rows[-1]), flush=True)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()

    base = rows[0]["ppl"]
    by_name = {r["format"]: r["ppl"] for r in rows}
    lines = [
        "# PPL report: per-bit-width deltas (offline protocol)",
        "",
        f"{args.model}, a self-sampled corpus of {len(tokens)} tokens,",
        f"window {args.max_length} / stride {args.stride}, out_scale "
        f"{OUT_SCALE}; see inferflow_tpu_torch/tools/ppl_report.py.",
        "",
        f"| format | PPL | stderr | delta vs {rows[0]['format']} |",
        "|---|---|---|---|",
    ]
    for r in rows:
        r["delta_vs_bf16"] = r["ppl"] - base
        wire = r["format"].split("+")[0]
        extra = ""
        if "+" in r["format"] and wire in by_name:
            r["vs_wire"] = r["ppl"] - by_name[wire]
            extra = f" ({r['vs_wire']:+.4f} vs {wire})"
        lines.append(f"| {r['format']} | {r['ppl']:.4f} | {r['stderr']:.4f}"
                     f" | {r['delta_vs_bf16']:+.4f}{extra} |")
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    lines += ["", f"Scored tokens per row: {rows[0]['scored']}; device: "
              f"{device_name}."]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"# wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
