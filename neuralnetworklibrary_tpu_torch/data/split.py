"""Train/validation splitting.

A copy of ``neuralnetworklibrary_tpu/data/split.py`` (``SplitTrainVal``,
General/Core.py:220-247), kept here because the port imports nothing of the
JAX package.  It needs only numpy: a DataFrame is recognised by its
``iloc`` indexer, so pandas is never imported.
"""

from __future__ import annotations

import numpy as np


def SplitTrainVal(datapoints, val_idxs=None, val_frac: float = 0.2,
                  seed: int | None = None):
    """Split a list or DataFrame into (train, val).

    If ``val_idxs`` is given it is used directly; otherwise a random
    ``val_frac`` fraction is sampled without replacement (seeded).
    """
    N = len(datapoints)
    if val_idxs is None:
        rng = np.random.default_rng(seed)
        val_idxs = list(rng.choice(np.arange(N), int(N * val_frac),
                                   replace=False))
    val_set = set(int(i) for i in val_idxs)
    train_idxs = [i for i in range(N) if i not in val_set]
    val_idxs = sorted(val_set)
    if hasattr(datapoints, "iloc"):
        return (datapoints.iloc[train_idxs].copy(),
                datapoints.iloc[val_idxs].copy())
    return [datapoints[i] for i in train_idxs], [datapoints[i]
                                                 for i in val_idxs]
