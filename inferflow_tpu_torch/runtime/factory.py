"""Engine factory: archetype-dispatched engine construction from config
(port of inferflow_tpu/runtime/factory.py).

reference: InferenceEngine::Init dispatches on NetworkType — decoder-only
models get the batching engine, encoder-only (BERT) the mask-prediction
path, encoder-decoder the two-pass path (inference_engine.cc:43-229,
893-954).  Decoder-only models go to InferenceEngine.from_config; the
encoder engines are not ported (ROADMAP A item 8) and raise.
"""

from __future__ import annotations

from .engine import InferenceEngine


def make_engine(config, model_index: int = 0,
                device="cuda") -> InferenceEngine:
    """Build the engine for the model's archetype from an EngineConfig, on
    `device` (the card unless the caller passes "cpu"): the whole config
    surface of a decoder-only model is wired by
    InferenceEngine.from_config."""
    spec = config.models[model_index]
    if spec.archetype in ("encoder_only", "encoder_decoder"):
        raise NotImplementedError(
            f"{spec.archetype} models (the encoder engines) are not ported "
            "(ROADMAP A item 8)")
    return InferenceEngine.from_config(config, model_index, device=device)
