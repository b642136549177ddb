"""inferflow-tpu on PyTorch and CUDA: the serving engine for one NVIDIA H100.

A second implementation of the ``inferflow_tpu`` package, module for module
(same module names, same public layouts), with every Pallas kernel on the
served path replaced by a CUDA C++ kernel written for Hopper (``sm_90a``)
under ``kernels/csrc``.  The JAX package stays the reference; this package
imports nothing of it and nothing of JAX.

Entry points (``runtime.factory.make_engine`` and
``runtime.engine.InferenceEngine.from_config``, which build an engine from an
ini and a checkpoint on disk, ``runtime.engine.InferenceEngine``,
``loaders.model_loader.load_model``, ``models.zoo.make_synthetic_params``, the
kernel wrappers) run on the card by default and raise when none is present,
unless the caller passes ``device="cpu"``; on CPU tensors the kernel wrappers
run their plain PyTorch versions.
"""

__version__ = "0.1.0"
