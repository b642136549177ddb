"""Perplexity harness (port of tools/perplexity.py; reference:
src/tools/perplexity.cc + bin/perplexity.ini).

Protocol: tokenize the whole corpus, slice into windows of `max_length`
with `stride`, run the forward pass per window, accumulate next-token NLL
via log-softmax over positions [first_eval, window_end), report
PPL +/- stderr (perplexity.cc:100-157, 278-287).  The forward is
``models.decoder.decoder_forward`` with no cache.

Usage:
  python -m inferflow_tpu_torch.tools.perplexity --model-dir <dir> \\
      [--quant Q4] --text data/wiki.test.raw [--max-length 512] [--stride 512]
  python -m inferflow_tpu_torch.tools.perplexity --zoo tinyllama-1.1b \\
      --quant Q4 --synthetic-text
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch


def compute_ppl(forward_fn, tokens, max_length=512, stride=512,
                progress=True):
    """forward_fn(window_tokens: (1, T) int32 numpy) -> logits (1, T, V)
    float32 (numpy or a tensor).

    Returns (ppl, stderr, nll_list).  Mirrors perplexity.cc: for each
    window starting at `begin`, evaluate positions [prev_end, end) via
    teacher forcing; NLL of token t+1 given logits at t."""
    n = len(tokens)
    nlls = []
    prev_end = 0
    begin = 0
    t0 = time.time()
    while begin + 1 < n:
        end = min(begin + max_length, n)
        window = np.asarray(tokens[begin:end], np.int32)[None, :]
        logits = forward_fn(window)
        if isinstance(logits, torch.Tensor):
            logits = logits.float().cpu().numpy()
        logits = np.asarray(logits, np.float32)[0]
        first_eval = max(prev_end - begin, 1)
        # log-softmax NLL for positions first_eval..end-begin-1
        for pos in range(first_eval, end - begin):
            row = logits[pos - 1]
            row = row - row.max()
            lse = math.log(np.exp(row, dtype=np.float64).sum())
            nlls.append(lse - float(row[window[0, pos]]))
        prev_end = end
        if end == n:
            break
        begin += stride
        if progress:
            print(f"\r# {end}/{n} tokens, interim ppl "
                  f"{math.exp(np.mean(nlls)):.4f}", end="", file=sys.stderr)
    if progress:
        print(f"\n# eval took {time.time() - t0:.1f}s", file=sys.stderr)
    nll = np.asarray(nlls)
    ppl = math.exp(nll.mean())
    stderr = ppl * nll.std(ddof=1) / math.sqrt(len(nll))
    return ppl, stderr, nlls


def make_forward(spec, params, device):
    """forward_fn for compute_ppl: the full forward over one window, no
    cache, on `device`; returns float32 logits (1, T, V)."""
    from ..models.decoder import decoder_forward

    def fwd(window):
        toks = torch.as_tensor(np.asarray(window), dtype=torch.long,
                               device=device)
        pos = torch.arange(toks.shape[1], dtype=torch.long,
                           device=device)[None, :]
        with torch.no_grad():
            logits, _ = decoder_forward(spec, params, toks, pos, None)
        return logits.float()

    return fwd


def self_text(spec, device, length: int, seed: int = 0,
              window: int = 128) -> list:
    """A corpus of `length` tokens sampled (temperature 0.9, a
    ``torch.Generator`` seeded with `seed`) from the bf16 model of `spec`
    (the same seed and shapes as the evaluated one), each token from the
    last `window` tokens: the JAX tool's --self-text protocol.  Returns
    [1] + the sampled tokens."""
    from ..models.zoo import make_synthetic_params
    gen_params = make_synthetic_params(spec, None, device=device)
    fwd = make_forward(spec, gen_params, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    hist = [1]
    out = []
    while len(out) < length:
        logits = fwd(np.asarray(hist[-window:], np.int32)[None, :])
        probs = torch.softmax(logits[0, -1] / 0.9, dim=-1)
        nxt = int(torch.multinomial(probs, 1, generator=gen))
        out.append(nxt)
        hist.append(nxt)
        if len(out) % 256 == 0:
            print(f"\r# generated {len(out)} tokens", end="",
                  file=sys.stderr)
    print("", file=sys.stderr)
    return [1] + out


def main(argv=None) -> dict:
    """Score the corpus; returns {"ppl", "stderr", "scored", "tokens"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir")
    ap.add_argument("--spec", default="model_spec.json")
    ap.add_argument("--zoo")
    ap.add_argument("--quant", default="")
    ap.add_argument("--layout", default="",
                    choices=["", "packed", "q8c", "i8mm", "i4", "mixed"],
                    help="device layout for --zoo synthetic params (the "
                    "PPL bit-width/layout ladder)")
    ap.add_argument("--text", help="corpus file (e.g. wiki.test.raw)")
    ap.add_argument("--tokenizer-bin", default="",
                    help="llama2.c tokenizer.bin for --zoo corpus eval")
    ap.add_argument("--synthetic-text", action="store_true")
    ap.add_argument("--self-text", action="store_true",
                    help="evaluate on text generated by the same model in "
                    "bf16: quantization PPL deltas are meaningful without "
                    "a real corpus or checkpoint")
    ap.add_argument("--self-text-len", type=int, default=2048)
    ap.add_argument("--self-text-cache", default="",
                    help="token cache file for the self-text corpus")
    ap.add_argument("--token-cache", default="",
                    help="tokenized-corpus cache file for --text runs")
    ap.add_argument("--max-length", type=int, default=512)
    ap.add_argument("--stride", type=int, default=512)
    ap.add_argument("--max-tokens", type=int, default=0,
                    help="cap corpus tokens (0 = all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the synthetic weights' and the samples' seed")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)
    tok = None
    if args.zoo:
        from ..models.zoo import make_spec, make_synthetic_params
        spec = make_spec(args.zoo)
        if args.layout:
            spec.device_layout = args.layout
        params = make_synthetic_params(spec, args.quant or None,
                                       seed=args.seed, device=device,
                                       device_layout=args.layout)
        if args.tokenizer_bin:
            from ..loaders.llama2c import load_llama2c_tokenizer
            from ..tokenizer.tokenizer import Tokenizer
            tok = Tokenizer(load_llama2c_tokenizer(
                args.tokenizer_bin, spec.hyper_params.vocab_size), "bpe")
    else:
        if not args.model_dir:
            sys.exit("--zoo or --model-dir is required")
        from ..config.model_spec import load_model_spec
        from ..loaders.model_loader import load_model
        from ..tokenizer.loading import load_tokenizer
        spec = load_model_spec(os.path.join(args.model_dir, args.spec))
        spec.dir = args.model_dir
        if args.quant:
            spec.device_weight_data_type = args.quant
        params = load_model(spec, device=device)
        tok = load_tokenizer(spec)

    if args.self_text and args.self_text_cache \
            and os.path.isfile(args.self_text_cache):
        tokens = np.load(args.self_text_cache).tolist()
    elif args.self_text:
        from ..models.zoo import make_spec
        gen_spec = make_spec(args.zoo) if args.zoo else spec
        tokens = self_text(gen_spec, device, args.self_text_len, args.seed)
        if args.self_text_cache:
            np.save(args.self_text_cache, np.asarray(tokens, np.int32))
    elif args.synthetic_text or not args.text:
        rng = np.random.default_rng(0)
        tokens = rng.integers(4, spec.hyper_params.vocab_size - 1,
                              size=4096).tolist()
    else:
        if args.token_cache and not args.token_cache.endswith(".npy"):
            args.token_cache += ".npy"  # np.save appends it on write
        if args.token_cache and os.path.isfile(args.token_cache):
            tokens = np.load(args.token_cache).tolist()
        else:
            with open(args.text, encoding="utf-8") as fh:
                text = fh.read()
            if tok is None:
                sys.exit("corpus eval needs a tokenizer")
            tokens = tok.tokenize(text, add_bos=True)
            if args.token_cache:
                np.save(args.token_cache, np.asarray(tokens, np.int32))
    if args.max_tokens:
        tokens = tokens[:args.max_tokens]
    print(f"# corpus: {len(tokens)} tokens", file=sys.stderr)

    ppl, stderr, nlls = compute_ppl(make_forward(spec, params, device),
                                    tokens, args.max_length, args.stride)
    print(f"PPL = {ppl:.4f} +/- {stderr:.4f}  ({len(nlls)} scored tokens)")
    return {"ppl": ppl, "stderr": stderr, "scored": len(nlls),
            "tokens": len(tokens)}


if __name__ == "__main__":
    main()
