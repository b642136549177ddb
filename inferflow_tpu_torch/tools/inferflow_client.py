"""HTTP client CLI (port of tools/inferflow_client.py; reference:
src/tools/inferflow_client.cc driven by bin/inferflow_client.ini).

Usage:
  python -m inferflow_tpu_torch.tools.inferflow_client --url
      http://127.0.0.1:8080 --query "Hello!" [--openai] [--stream]
"""

from __future__ import annotations

import argparse

from ..serving.client import InferFlowClient


def main(argv=None) -> str:
    """Send one query and print the answer; returns its text."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--config", help="ini with [client] url/query keys")
    ap.add_argument("--query", default="Hello!")
    ap.add_argument("--system-prompt", default="")
    ap.add_argument("--max-output-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--openai", action="store_true")
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args(argv)

    url, query = args.url, args.query
    if args.config:
        from ..config import ConfigData
        cfg = ConfigData.load(args.config)
        url = cfg.get("client", "url", url)
        query = cfg.get("client", "query", query)

    client = InferFlowClient(url)
    if args.stream:
        pieces = []
        for chunk in client.stream(query, args.max_output_len,
                                   openai=args.openai):
            if args.openai:
                delta = chunk["choices"][0]["delta"].get("content", "")
            else:
                delta = chunk.get("text", "")
            pieces.append(delta)
            print(delta, end="", flush=True)
        print()
        return "".join(pieces)
    resp = client.query(query, args.system_prompt, args.max_output_len,
                        args.temperature, openai=args.openai)
    text = (resp["choices"][0]["message"]["content"] if args.openai
            else resp.get("text", ""))
    print(text)
    return text


if __name__ == "__main__":
    main()
