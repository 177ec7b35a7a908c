"""Collaborative filtering: (user, item) -> rating.

Counterpart of ``neuralnetworklibrary_tpu/applications/collab.py`` (the
reference's Applications/CollabFiltering.py).  The data path relabels raw
user and item ids to contiguous ints on the host and yields (N, 2) int
pairs; the model is an embedding dot product with user and item biases
and a sigmoid range squash (CollabFiltering.py:196-204).

A "frame" is a pandas DataFrame or a dict of equal-length numpy columns
(the card's machine has no pandas); pandas is imported only inside
``from_csv``.  An ensemble's members live under ``models_{i}``, as in the
JAX module's parameter tree; :func:`ensemble_params` merges trained
members' state dicts into the ensemble's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from neuralnetworklibrary_tpu_torch.data.loader import ArrayDataset, DataLoader
from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal
from neuralnetworklibrary_tpu_torch.nn.layers import Embedding, sigmoidal_range
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device


def _column(frame, col) -> np.ndarray:
    return np.asarray(frame[col])


def _unique_in_order(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a`` in order of first appearance (pandas'
    ``unique``)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _relabel(values: np.ndarray, labels: dict) -> np.ndarray:
    """``labels[v]`` for every v, as int32; an id missing from ``labels``
    raises KeyError."""
    keys = np.asarray(list(labels.keys()))
    codes = np.asarray(list(labels.values()), np.int64)
    order = np.argsort(keys, kind="stable")
    keys, codes = keys[order], codes[order]
    pos = np.clip(np.searchsorted(keys, values), 0, max(len(keys) - 1, 0))
    if len(keys) == 0 or not np.array_equal(keys[pos], values):
        missing = values[keys[pos] != values] if len(keys) else values
        raise KeyError(f"ids without a label: {missing[:5].tolist()}")
    return codes[pos].astype(np.int32)


def _take(frame, idxs):
    if hasattr(frame, "iloc"):
        return frame.iloc[idxs].copy()
    return {k: np.asarray(v)[idxs] for k, v in frame.items()}


class CollabFilterDataset(ArrayDataset):
    """Dataset of ((user, item) int pairs, rating) (CollabFiltering.py:
    29-72); ``labels = [user_labels, item_labels]`` map raw ids to
    contiguous ints.  Without ``rating_col`` the ratings are zeros."""

    def __init__(self, df, user_col, item_col, rating_col, labels):
        user_labels, item_labels = labels
        u = _relabel(_column(df, user_col), user_labels)
        it = _relabel(_column(df, item_col), item_labels)
        x = np.stack([u, it], axis=1)
        if rating_col is None:
            y = np.zeros(len(x), np.float32)
        else:
            y = _column(df, rating_col).astype(np.float32)
        super().__init__(x, y)
        self.x, self.y = x, y
        self.y_range = [float(y.min()), float(y.max())]


class CollabFilterDataObj:
    """Datasets + loaders for train / val (/ test) (CollabFiltering.py:
    75-165)."""

    def __init__(self, train_df, val_df, user_col, item_col, rating_col,
                 labels, bs, test_df=None, seed: int = 0):
        self.bs = bs
        self.labels = labels
        self.target_type = "cont"
        self.train_ds = CollabFilterDataset(train_df, user_col, item_col,
                                            rating_col, labels)
        self.val_ds = CollabFilterDataset(val_df, user_col, item_col,
                                          rating_col, labels)
        self.train_dl = DataLoader(self.train_ds, bs, shuffle=True, seed=seed)
        self.val_dl = DataLoader(self.val_ds, bs, shuffle=False)
        if test_df is not None:
            self.test_ds = CollabFilterDataset(test_df, user_col, item_col,
                                               None, labels)
            self.test_dl = DataLoader(self.test_ds, bs, shuffle=False)

    @classmethod
    def from_dataframes(cls, train_df, user_col, item_col, rating_col, bs,
                        val_df=None, test_df=None, val_idxs=None,
                        val_frac=0.2, seed=0):
        """Label dicts from the train frame (ids in order of appearance),
        then a seeded ``SplitTrainVal`` unless ``val_df`` is given."""
        users = _unique_in_order(_column(train_df, user_col))
        items = _unique_in_order(_column(train_df, item_col))
        labels = [{u: i for i, u in enumerate(users.tolist())},
                  {v: i for i, v in enumerate(items.tolist())}]
        if val_df is None:
            n = len(_column(train_df, user_col))
            train_idxs, val_idxs = SplitTrainVal(list(range(n)), val_idxs,
                                                 val_frac, seed=seed)
            train_df, val_df = (_take(train_df, train_idxs),
                                _take(train_df, val_idxs))
        return cls(train_df, val_df, user_col, item_col, rating_col, labels,
                   bs, test_df=test_df, seed=seed)

    @classmethod
    def from_csv(cls, train_csv, user_col, item_col, rating_col, bs,
                 val_csv=None, test_csv=None, val_idxs=None, val_frac=0.2,
                 seed=0):
        """From csv file(s) with label dicts built on the train file
        (CollabFiltering.py:118-165)."""
        import pandas as pd

        train_df = pd.read_csv(train_csv)
        val_df = pd.read_csv(val_csv) if val_csv else None
        test_df = pd.read_csv(test_csv) if test_csv else None
        return cls.from_dataframes(train_df, user_col, item_col, rating_col,
                                   bs, val_df=val_df, test_df=test_df,
                                   val_idxs=val_idxs, val_frac=val_frac,
                                   seed=seed)


class CollabFilterNet(nn.Module):
    """Embedding dot product + user and item biases + optional sigmoid
    range squash (CollabFiltering.py:168-213).  x (B, 2) int (user, item)
    -> (B,) ratings.  The whole model is one layer group with no head, as
    in the reference.  ``device`` defaults to cuda."""

    layer_group_prefixes = None
    head_prefixes = ("head",)

    def __init__(self, n_user: int, n_item: int, emb_dim: int,
                 output_range: Optional[Sequence[float]] = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.output_range = output_range
        self.user_emb = Embedding(n_user, emb_dim, device=dev)
        self.item_emb = Embedding(n_item, emb_dim, device=dev)
        self.user_bias = Embedding(n_user, 1, device=dev)
        self.item_bias = Embedding(n_item, 1, device=dev)

    def forward(self, x, train: bool = False):
        users, items = x[:, 0], x[:, 1]
        out = (self.user_emb(users) * self.item_emb(items)).sum(1) \
            + self.user_bias(users)[:, 0] + self.item_bias(items)[:, 0]
        if self.output_range is not None:
            out = sigmoidal_range(out, self.output_range)
        return out

    @classmethod
    def from_dataobj(cls, data: CollabFilterDataObj, emb_dim: int,
                     output_range="default", device=None):
        """'default' output range: the train ratings' range widened by 5%
        of its span at each end."""
        n_user, n_item = len(data.labels[0]), len(data.labels[1])
        if output_range == "default":
            lo, hi = data.train_ds.y_range
            output_range = (lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo))
        elif output_range is not None:
            output_range = tuple(output_range)
        return cls(n_user, n_item, emb_dim, output_range, device=device)


class CollabFilterEnsembleNet(nn.Module):
    """Weighted average of collab models (CollabFiltering.py:216-242),
    uniform by default; members under ``models_{i}``."""

    layer_group_prefixes = None
    head_prefixes = ("head",)

    def __init__(self, models, weights=None):
        super().__init__()
        self.n_models = len(models)
        for i, m in enumerate(models):
            self.add_module(f"models_{i}", m)
        self.weights = (tuple(weights) if weights is not None
                        else (1.0 / self.n_models,) * self.n_models)

    def forward(self, x, train: bool = False):
        out = 0.0
        for i in range(self.n_models):
            out = out + self.weights[i] * getattr(self, f"models_{i}")(
                x, train=train)
        return out


def ensemble_params(member_states: Sequence[dict]) -> dict:
    """One state dict for a :class:`CollabFilterEnsembleNet` (or any net
    whose members sit under ``models_{i}``) from its trained members'
    state dicts, to pass to ``load_state_dict``."""
    return {f"models_{i}.{k}": v for i, sd in enumerate(member_states)
            for k, v in sd.items()}
