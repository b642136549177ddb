"""HTTP serving: streaming service + OpenAI-compatible API + client (port of
inferflow_tpu/serving/).

reference: src/service/ (inferflow_service.cc, service_data.cc).
"""

from .http_server import InferFlowService, InferFlowServiceCore  # noqa: F401
from .service_data import InferFlowRequest, ResponseChunk  # noqa: F401
from .client import InferFlowClient  # noqa: F401
