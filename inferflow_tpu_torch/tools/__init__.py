"""Command-line entry points of the port (ports of the JAX package's
tools/inferflow_service.py, tools/llm_inference.py and
tools/inferflow_client.py), run as ``python -m
inferflow_tpu_torch.tools.<name>``."""
