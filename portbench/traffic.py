"""The one traffic generator: a mix is a JSON file of parameters under
``portbench/traffic/<mix>.json``, read by :func:`load` and turned into a
pool of training rows by :func:`make`.

A mix's parameters:

- ``rows``, ``seq_len``: the batch (B rows of T tokens);
- ``pool_batches``: how many batches the pool holds; the window cycles it;
- ``doc_len``: document lengths, log-normal with ``median`` and ``sigma``,
  clipped to [``min``, ``max``], drawn from the run's seed
  (:func:`doc_lengths`);
- ``zipf``: tokens are drawn Zipf-like, rank r with weight 1 / (r + 1) **
  zipf, the ranks on a random permutation of the configuration's
  document token ids;
- ``arrange``: ``"pack"`` packs whole documents (each closed by the
  separator) into rows of T + 1 tokens with the program's packer, padded
  with the configuration's pad id; ``"stream"`` joins them, each closed by
  the separator, into one stream cut into consecutive rows of T + 1;
- ``source``: where the lengths come from (read by no code).

Every ``--seed`` draws its own documents' lengths, places and tokens from
the same distributions.

Rows of T + 1 raw tokens give x = row[:-1] and y = row[1:].
"""

from __future__ import annotations

import json
import math
import os
import statistics

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def doc_lengths(rng, mix: dict, total: int) -> list:
    """Document lengths drawn from ``rng`` that hold at least ``total``
    tokens (separators included), in random order.

    The draw is stratified: the i-th of n lengths is the log-normal's
    quantile at (i + u) / n, u uniform from ``rng``.  Each seed draws its
    own lengths, but the n of every seed follow the distribution closely,
    so the attention work of a pool (its attended pairs) barely moves
    from seed to seed."""
    d = mix["doc_len"]
    mean = d["median"] * math.exp(d["sigma"] ** 2 / 2)
    n, z = max(1, int(total / (mean + 1))), statistics.NormalDist()
    while True:
        u = np.clip((np.arange(n) + rng.random(n)) / n, 1e-12, 1 - 1e-12)
        lengths = np.clip(np.exp(np.log(d["median"]) + d["sigma"] * np.array(
            [z.inv_cdf(v) for v in u])), d["min"], d["max"]).astype(int)
        if int(lengths.sum()) + n >= total:
            return [int(v) for v in rng.permutation(lengths)]
        n = int(n * 1.05) + 1


def draw_tokens(rng, n: int, id_range, zipf: float) -> np.ndarray:
    """``n`` token ids in [lo, hi), Zipf-like over a random ranking."""
    lo, hi = id_range
    ids = lo + rng.permutation(hi - lo)
    w = 1.0 / np.arange(1, hi - lo + 1, dtype=np.float64) ** zipf
    cdf = np.cumsum(w / w.sum())
    pick = np.minimum(np.searchsorted(cdf, rng.random(n)), hi - lo - 1)
    return ids[pick].astype(np.int32)


def make(mix: dict, data: dict, seed: int, pack=None) -> dict:
    """The pool of a run: ``x``, ``y`` (pool_batches * rows, T) int32 in
    the order the window takes them; for ``"pack"`` also ``docs`` (the
    documents, token arrays without their separator) and ``packed`` (the
    packer's whole output (x, y), of which the pool is the first rows).

    ``data`` holds the configuration's ``separator``, ``pad`` (None where
    there is none) and ``token_ids`` ([lo, hi)).  ``pack`` is the
    program's packer, ``pack(docs, seq_len, sep, pad) -> (x, y, pad)``."""
    B, T = mix["rows"], mix["seq_len"]
    n_rows = mix["pool_batches"] * B
    sep = data["separator"]
    rng = np.random.default_rng(seed)
    if mix["arrange"] == "pack":
        lengths = doc_lengths(rng, mix, int(n_rows * (T + 1) * 1.02))
        tokens = draw_tokens(rng, sum(lengths), data["token_ids"],
                             mix["zipf"])
        docs = np.split(tokens, np.cumsum(lengths)[:-1])
        x, y, _ = pack(docs, T, sep, data["pad"])
        if len(x) < n_rows:
            raise ValueError(f"packing gave {len(x)} rows < {n_rows}")
        order = rng.permutation(n_rows)
        return {"x": x[:n_rows][order], "y": y[:n_rows][order],
                "docs": docs, "packed": (x, y)}
    if mix["arrange"] == "stream":
        need = n_rows * (T + 1)
        lengths = doc_lengths(rng, mix, need)
        tokens = draw_tokens(rng, sum(lengths), data["token_ids"],
                             mix["zipf"])
        stream = np.empty(sum(lengths) + len(lengths), np.int32)
        ends = np.cumsum(np.asarray(lengths) + 1) - 1
        body = np.ones(len(stream), bool)
        body[ends] = False
        stream[ends] = sep
        stream[body] = tokens
        rows = stream[:need].reshape(n_rows, T + 1)
        rows = rows[rng.permutation(n_rows)]
        return {"x": np.ascontiguousarray(rows[:, :-1]),
                "y": np.ascontiguousarray(rows[:, 1:])}
    raise ValueError(f"unknown arrange {mix['arrange']!r}")
