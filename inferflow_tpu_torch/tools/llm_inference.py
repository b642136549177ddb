"""Batch inference CLI (port of tools/llm_inference.py; reference:
src/tools/llm_inference.cc).

Drives add_query / infer / commit_inference_result over the prompts,
prints the generated text and tokens per second (llm_inference.cc:454-457).

Usage:
  python -m inferflow_tpu_torch.tools.llm_inference --config <ini>
      [--data-root <dir>/] [--prompt "..."] [--max-new 128]
  python -m inferflow_tpu_torch.tools.llm_inference --model-dir <dir>
      [--spec model_spec.json] [--quant Q4_B64T1] [--prompt "..."]
  python -m inferflow_tpu_torch.tools.llm_inference --zoo tinyllama-1.1b
      --quant Q4_B64T1                                    # synthetic bench
Every engine runs on the card unless ``--device cpu``.  The llama2.c
tokenizer fallback of the JAX tool is not ported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_engine(args, device):
    from ..runtime.engine import InferenceEngine

    if args.zoo:
        from ..models.zoo import make_spec, make_synthetic_params
        spec = make_spec(args.zoo)
        params = make_synthetic_params(spec, args.quant or None,
                                       device=device)
        return InferenceEngine(spec, params,
                               max_concurrent_queries=args.max_queries,
                               device=device), None

    if args.config:
        from ..config import load_engine_config
        ec = load_engine_config(args.config, data_root_dir=args.data_root)
        spec = ec.model
        if spec is None:
            sys.exit("no model configured")
        max_q = ec.max_concurrent_queries
    else:
        from ..config.model_spec import load_model_spec
        spec = load_model_spec(os.path.join(args.model_dir,
                                            args.spec or "model_spec.json"))
        spec.dir = args.model_dir
        max_q = args.max_queries
    if args.quant:
        spec.device_weight_data_type = args.quant

    from ..loaders.model_loader import load_model
    from ..tokenizer.loading import load_tokenizer
    t0 = time.time()
    params = load_model(spec, device=device)
    print(f"# model loaded in {time.time() - t0:.1f}s", file=sys.stderr)
    tok = load_tokenizer(spec)
    eng = InferenceEngine(spec, params, max_concurrent_queries=max_q,
                          tokenizer=tok, vocab=tok.vocab if tok else None,
                          device=device)
    return eng, tok


def main(argv=None) -> dict:
    """Run the prompts; returns {query id: generated tokens}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", help="service ini")
    ap.add_argument("--data-root", default="",
                    help="the ini's ${data_root_dir} (default: the ini's "
                         "directory)")
    ap.add_argument("--model-dir", help="model directory")
    ap.add_argument("--spec", help="model_spec.json filename")
    ap.add_argument("--zoo", help="synthetic zoo model name")
    ap.add_argument("--quant", default="", help="weight format override")
    ap.add_argument("--prompt", action="append", default=[])
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--max-queries", type=int, default=8)
    ap.add_argument("--strategy", default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..sampling.strategies import SamplingOptions
    device = resolve_device(args.device)
    eng, tok = build_engine(args, device)

    prompts = args.prompt or ["Once upon a time"]
    opts = SamplingOptions(strategy=args.strategy,
                           temperature=args.temperature)

    # dynamic batching: add all queries, run the engine loop
    qids = []
    for p in prompts:
        if tok is None and not args.config and args.zoo:
            q = eng.add_query(list(range(1, 17)), opts, args.max_new)
        else:
            q = eng.add_query(p, opts, args.max_new)
        if q > 0:
            qids.append((q, p))
        else:
            print(f"# query rejected ({q}): {p!r}", file=sys.stderr)

    t0 = time.time()
    steps = 0
    while eng.has_work():
        eng.commit_inference_result(eng.infer())
        steps += 1
    dt = time.time() - t0

    total_tokens = 0
    out = {}
    for qid, p in qids:
        toks = eng.query_tokens(qid)
        out[qid] = toks
        total_tokens += len(toks)
        text = eng.tokenizer.decode(toks) if eng.tokenizer else str(toks)
        print(f"=== query {qid}: {p!r}\n{text}\n")
    print(f"# {total_tokens} tokens in {dt:.2f}s -> "
          f"{total_tokens / max(dt, 1e-9):.2f} tokens/sec "
          f"({steps} engine steps)", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
