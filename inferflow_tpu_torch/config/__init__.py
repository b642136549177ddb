"""Configuration: ini parsing with macro expansion, model_spec.json,
service/engine config.

A copy of inferflow_tpu/config/ (pure Python, no backend), kept here so
this package imports nothing of the JAX one.

reference: sslib ConfigData (3rd_party/sslib/config_data.h),
InferenceEngine::LoadConfig (src/transformer/inference_engine.cc:1412-1836),
ModelReader::LoadModelSpecJson (model_reader.cc:194-446).
"""

from .ini import ConfigData  # noqa: F401
from .model_spec import load_model_spec  # noqa: F401
from .engine_config import (EngineConfig, load_engine_config,  # noqa: F401
                            parse_device_groups)
