"""Continuous-batching serving engines (dense and paged KV cache)."""

from neuralnetworklibrary_tpu_torch.serving.engine import (  # noqa: F401
    Request,
    ServingEngine,
)
from neuralnetworklibrary_tpu_torch.serving.paged import (  # noqa: F401
    PagedServingEngine,
)
