"""Language-model losses.

Counterpart of ``SeqCrossEntropyLoss`` in
``neuralnetworklibrary_tpu/applications/text.py``: model outputs are
``(logits, h)`` tuples, as ``TransformerLM`` returns them.
"""

from __future__ import annotations

from neuralnetworklibrary_tpu_torch.core.metrics import (
    seq_cross_entropy_loss,
)


class SeqCrossEntropyLoss:
    """Unregularized sequence CE (Text.py:779-788), the quantity reported
    as val loss for LMs: the softmax CE of every token of the valid rows,
    averaged."""

    def __call__(self, outputs, target, mask=None):
        return seq_cross_entropy_loss(outputs, target, mask)
