"""Tokenizer data converter (port of tools/convert_tokenizer_data.py;
reference: src/tools/convert_tokenizer_data.cc: vocab json -> the
engine's binary vocab format).

Converts a HF tokenizer.json / vocab.json into the llama2.c-style binary
vocab (``tokenizer.bin``: u32 max_token_len, then per token {f32 score,
u32 len, bytes}) that ``loaders/llama2c.load_llama2c_tokenizer`` reads.
Host code only: it touches no device.

Usage: python -m inferflow_tpu_torch.tools.convert_tokenizer_data
       tokenizer.json tokenizer.bin [--merges merges.txt] [--byte-mapping 0]
"""

from __future__ import annotations

import argparse
import struct
import sys

from ..tokenizer.loading import load_tokenizer_json, load_vocab_json


def main(argv=None) -> int:
    """Write the binary vocab; returns the number of tokens written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="tokenizer.json or vocab.json")
    ap.add_argument("output", help="output tokenizer.bin")
    ap.add_argument("--merges", default="", help="merges.txt for vocab.json")
    ap.add_argument("--byte-mapping", type=int, default=0)
    args = ap.parse_args(argv)

    if args.input.endswith("vocab.json"):
        vocab = load_vocab_json(args.input, args.merges, args.byte_mapping)
    else:
        vocab = load_tokenizer_json(args.input, args.byte_mapping)

    max_len = max((len(t.str) for t in vocab.tokens), default=0)
    with open(args.output, "wb") as fh:
        fh.write(struct.pack("<I", max_len))
        for tok in vocab.tokens:
            fh.write(struct.pack("<f", tok.score))
            fh.write(struct.pack("<I", len(tok.str)))
            fh.write(tok.str)
    print(f"# wrote {len(vocab.tokens)} tokens to {args.output}",
          file=sys.stderr)
    return len(vocab.tokens)


if __name__ == "__main__":
    main()
