"""The numbers that decide ``correct``, from the program's readings and the
reference's, and their limits.

Readings (of a training step's first steps, as ``reference.common.train``
returns them): ``losses``, one per step; ``grad_sq``, each leaf's squared
gradient norm at step 1; ``change_sq``, each leaf's squared change after
the last step.  Both sides' come by the reference's leaves: the program's
are read from the rows of its own leaves that hold each (a fused
projection holds several).

Numbers:

- ``loss_gap``: the largest |program - reference| / reference loss over
  the steps;
- ``grad_gap``: over the leaves, the largest gap between the program's
  gradient norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change_gap``: the same for the change of the parameters after the
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding, as a key's bias under softmax, moves under Adam by round-off
  alone);
- ``grad_diff`` (where the cell's limits name it, and both sides kept
  their step-1 gradients, ``grads``): over the leaves, the norm of the
  difference of the two sides' step-1 gradients, over the larger of the
  reference's norm of that leaf and of the median leaf.  Norms alone miss
  a gradient that points elsewhere with the same length, as the mean over
  half of a batch of like rows does;
- ``packing_faults`` (packed mixes only): documents that the packer's
  rows do not hold exactly once, and rows that are not whole documents
  each closed by the separator and then pads.
"""

from __future__ import annotations

import math
import statistics
from collections import Counter

import numpy as np

COUNTED = 1e-3


def _gap(prog: dict, ref: dict, leaves, scale=None) -> tuple:
    """The worst leaf's |prog - ref| over the larger of its ``scale`` (by
    default ``ref``) and the median leaf's."""
    scale = ref if scale is None else scale
    med = statistics.median(scale[k] for k in leaves)
    worst, leaf = 0.0, None
    for k in leaves:
        g = abs(prog[k] - ref[k]) / max(scale[k], med, 1e-30)
        if not g <= worst:  # a NaN reads as the worst
            worst, leaf = (g if math.isfinite(g) else math.inf), k
    return worst, leaf


def numbers(prog: dict, ref: dict) -> tuple:
    """({name: value}, {name: the leaf or step that set it})."""
    if set(prog["grad_sq"]) != set(ref["grad_sq"]):
        odd = sorted(set(prog["grad_sq"]) ^ set(ref["grad_sq"]))
        raise ValueError(f"the two sides' leaves differ: {odd}")
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    loss = [g if math.isfinite(g) else math.inf for g in loss]
    pg, rg, pc, rc = ({k: math.sqrt(v) for k, v in side[key].items()}
                      for side, key in ((prog, "grad_sq"), (ref, "grad_sq"),
                                        (prog, "change_sq"),
                                        (ref, "change_sq")))
    med = statistics.median(rg.values())
    counted = [k for k in rg if rg[k] >= COUNTED * med]
    grad, grad_leaf = _gap(pg, rg, list(rg))
    change, change_leaf = _gap(pc, rc, counted)
    step = int(np.argmax(loss)) + 1
    values = {"loss_gap": max(loss), "grad_gap": grad, "change_gap": change}
    where = {"loss_gap": f"step {step}", "grad_gap": grad_leaf,
             "change_gap": change_leaf}
    if "grads" in prog and "grads" in ref:
        diff = {k: float((prog["grads"][k].double()
                          - ref["grads"][k].double()).norm()) for k in rg}
        values["grad_diff"], where["grad_diff"] = _gap(
            diff, {k: 0.0 for k in rg}, list(rg), scale=rg)
    return values, where


def packing_faults(docs, x, y, separator, pad) -> int:
    """How far the packed rows (x, y) are from holding every document of
    ``docs`` once: rows that are not whole documents each closed by the
    separator and then pads, plus documents missing or held twice."""
    faults = 0
    held = Counter()
    for row_x, row_y in zip(x, y):
        # x is the row without its last token, y without its first, except
        # that x holds a pad where the row's last separator ends it early
        diff = row_x[1:] != row_y[:-1]
        early = diff & (row_x[1:] == pad) & (row_y[:-1] == separator)
        if np.any(diff & ~early) or early.sum() > 1:
            faults += 1
            continue
        row = np.concatenate([row_x[:1], row_y])
        ends = np.flatnonzero(row == separator)
        tail = row[ends[-1] + 1:] if len(ends) else row
        if len(ends) == 0 or np.any(tail != pad):
            faults += 1
        start = 0
        for e in ends:
            held[row[start:e].tobytes()] += 1
            start = e + 1
    want = Counter(np.asarray(d, np.int32).tobytes() for d in docs)
    held.subtract(want)
    return faults + sum(abs(n) for n in held.values())


def judge(values: dict, limits: dict) -> bool:
    """Every number has a limit and is within it (a non-finite one is
    not)."""
    return bool(values) and all(
        k in limits and math.isfinite(v) and v <= limits[k]
        for k, v in values.items())
