"""Model modules."""

from neuralnetworklibrary_tpu_torch.nn.transformer import (  # noqa: F401
    TransformerLM,
    init_cache,
)
