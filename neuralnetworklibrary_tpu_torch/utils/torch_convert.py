"""Helpers for reading torch checkpoints.

A copy of what the port needs of ``neuralnetworklibrary_tpu/utils/
torch_convert.py``: ``_np`` takes a torch tensor or an array (a checkpoint
unpickled without torch) to numpy.
"""

from __future__ import annotations

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)
