"""Model modules."""

from neuralnetworklibrary_tpu_torch.nn.seq2seq import (  # noqa: F401
    TransformerSeq2Seq,
    init_seq2seq_cache,
    seq2seq_generate,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import (  # noqa: F401
    TransformerLM,
    init_cache,
)
