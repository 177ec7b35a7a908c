"""Sequence packing for LM training: whole documents in fixed-length rows
(first-fit-decreasing bin packing) instead of one padded row each.

A copy of ``neuralnetworklibrary_tpu/data/packing.py`` (numpy), kept here
because the port imports nothing of the JAX package.  Pair the rows with
``nn.transformer.TransformerLM(reset_at=eos_token)`` (attention within
each document, positions restarting at each) and
``nn.transformer.PackedSeqCrossEntropyLoss(pad)`` (pad targets left out).
"""

from __future__ import annotations

import numpy as np


def pack_documents(docs, seq_len: int, eos_token: int,
                   pad_token: int | None = None):
    """Pack documents (each gets a trailing ``eos_token``) into
    ``(N, seq_len)`` next-token-prediction rows.

    First-fit-decreasing over row capacity ``seq_len + 1`` (x and y are the
    row shifted by one, so a row holds seq_len + 1 raw tokens); short rows
    are right-padded with ``pad_token`` (default: the eos token; pass a
    dedicated id when the eos token is a target to train on).

    Returns (x, y, pad): x, y (N, seq_len) int32; pad the id to hand to
    ``PackedSeqCrossEntropyLoss``.
    """
    pad = eos_token if pad_token is None else pad_token
    cap = seq_len + 1
    items = sorted(([int(t) for t in d] + [int(eos_token)] for d in docs),
                   key=len, reverse=True)
    if items and len(items[0]) > cap:
        raise ValueError(
            f"document of {len(items[0]) - 1} tokens (+eos) exceeds the "
            f"row capacity {cap}; raise seq_len or split the document")
    rows: list[list[int]] = []
    for it in items:
        for r in rows:
            if len(r) + len(it) <= cap:
                r.extend(it)
                break
        else:
            rows.append(list(it))
    x = np.full((len(rows), seq_len), pad, np.int32)
    y = np.full((len(rows), seq_len), pad, np.int32)
    for i, r in enumerate(rows):
        arr = np.asarray(r, np.int32)
        x[i, :len(r) - 1] = arr[:-1]
        y[i, :len(r) - 1] = arr[1:]
    return x, y, pad
