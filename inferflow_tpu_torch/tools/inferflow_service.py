"""HTTP service entry point (port of tools/inferflow_service.py; reference:
src/service/inferflow_service_main.cc + bin/inferflow_service.ini).

Usage:
  python -m inferflow_tpu_torch.tools.inferflow_service --config <ini>
      [--data-root <dir>/] [--port N] [--host 0.0.0.0] [--device cuda|cpu]
  python -m inferflow_tpu_torch.tools.inferflow_service --zoo tinyllama-1.1b
      --quant Q4_B64T1 --port 8080

Builds the engine (``make_engine`` on the ini; a synthetic zoo model with
``--zoo``) on the card unless ``--device cpu``, warms it up (the kernels'
build, one prefill per bucket and one decode step) and then binds and
serves POST / and /v1/chat/completions.  Multi-host serving
(``--coordinator``, ``--num-processes``, ``--process-id``) is not ported
(ROADMAP A item 10).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, block: bool = True):
    """Build, warm up and serve.  block=False returns the started
    InferFlowService (the caller stops it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", help="service ini")
    ap.add_argument("--data-root", default="",
                    help="the ini's ${data_root_dir} (default: the ini's "
                         "directory)")
    ap.add_argument("--zoo", help="synthetic zoo model (no checkpoint)")
    ap.add_argument("--quant", default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-queries", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    # multi-host serving: not ported
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.coordinator or args.num_processes > 1 or args.process_id:
        raise NotImplementedError(
            "multi-host serving (--coordinator, --num-processes, "
            "--process-id) is not ported (ROADMAP A item 10)")

    from ..device import resolve_device
    from ..runtime.engine import InferenceEngine
    from ..runtime.factory import make_engine
    from ..serving import InferFlowService

    device = resolve_device(args.device)
    port = args.port
    template = ""
    name = "inferflow-tpu"
    if args.config:
        from ..config import load_engine_config
        ec = load_engine_config(args.config, data_root_dir=args.data_root)
        eng = make_engine(ec, device=device)
        port = port or ec.http_port
        spec = ec.model
        template = spec.decoder_input_template or ec.default_prompt_template
        name = spec.sid or name
    elif args.zoo:
        from ..models.zoo import make_spec, make_synthetic_params
        spec = make_spec(args.zoo)
        params = make_synthetic_params(spec, args.quant or None,
                                       device=device)
        eng = InferenceEngine(spec, params,
                              max_concurrent_queries=args.max_queries,
                              device=device)
        name = args.zoo
        port = port or 8080
    else:
        sys.exit("need --config or --zoo")

    print("# warming up (kernels, prefill buckets, one decode step)...",
          file=sys.stderr)
    eng.warmup()
    svc = InferFlowService(eng, port=port, prompt_template=template,
                           model_name=name, host=args.host)
    print(f"# serving {name} on http://{args.host}:{svc.port} "
          f"(POST / or /v1/chat/completions)", file=sys.stderr, flush=True)
    if not block:
        svc.start(block=False)
        return svc
    try:
        svc.start(block=True)
    except KeyboardInterrupt:
        svc.stop()
    return None


if __name__ == "__main__":
    main()
