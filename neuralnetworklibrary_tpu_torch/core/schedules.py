"""Per-minibatch hyperparameter schedules (numpy; runs on the host).

A copy of ``neuralnetworklibrary_tpu/core/schedules.py``, kept here because
the port imports nothing of the JAX package: ``get_sched``,
``one_cycle_scheds`` and ``cycles_sched`` with the reference's formulas
(General/Learner.py:690-799).  Schedules are (N,) arrays for scalar
start/end values and (N, L) for length-L per-layer-group vectors.
"""

from __future__ import annotations

import numpy as np


def _as_arr(v):
    if isinstance(v, (list, tuple)):
        return np.asarray(v, dtype=np.float64)
    return v


def get_sched(sched_type: str, N: int, start_val, end_val) -> np.ndarray:
    """Return N schedule points from start_val to end_val.

    Types (formulas from Learner.py:718-728):
      'linear' — linearly spaced.
      'cos'    — y = end + (start-end) * 0.5*(cos(x)+1), x linspace [0, pi].
      'exp'    — y = e^x for x linspace [log start, log end].
      'poly'   — y_i = start * (i+1)^p, p chosen so y_{N-1} = end.

    start_val/end_val may be scalars or length-L vectors (returns (N, L)).
    """
    start_val, end_val = _as_arr(start_val), _as_arr(end_val)
    vector = np.ndim(start_val) > 0 or np.ndim(end_val) > 0
    start_val = np.asarray(start_val, dtype=np.float64)
    end_val = np.asarray(end_val, dtype=np.float64)
    if vector:
        start_val, end_val = np.broadcast_arrays(
            np.atleast_1d(start_val), np.atleast_1d(end_val)
        )

    if sched_type == "linear":
        out = np.linspace(start_val, end_val, N)
    elif sched_type == "cos":
        s = 0.5 * (np.cos(np.linspace(0.0, np.pi, N)) + 1.0)
        out = end_val + np.multiply.outer(s, start_val - end_val)
    elif sched_type == "exp":
        out = np.exp(np.linspace(np.log(start_val), np.log(end_val), N))
    elif sched_type == "poly":
        p = np.log(end_val / start_val) / np.log(N)
        i = np.arange(1, N + 1, dtype=np.float64)
        out = start_val * np.power.outer(i, p)
    else:
        raise ValueError(f"unknown sched_type {sched_type!r}")
    return out


def one_cycle_scheds(
    N: int,
    lr_max,
    div_fac: float = 25.0,
    start_pct: float = 0.3,
    mom_min: float = 0.85,
    mom_max: float = 0.95,
    beta_min: float = 0.85,
    beta_max: float = 0.95,
) -> dict[str, np.ndarray]:
    """1cycle schedules (Learner.py:787-799).

    lr: linear warmup lr_max/div_fac → lr_max over N1 = int(N*start_pct)
    steps, then cosine decay lr_max → (lr_max/div_fac)/1e4 over N - N1 steps.
    Momentum and beta1 run inversely: max → min → max.
    """
    lr_max = _as_arr(lr_max)
    N1 = int(N * start_pct)
    N2 = N - N1
    lr_min = lr_max / div_fac
    lr = np.concatenate(
        [get_sched("linear", N1, lr_min, lr_max), get_sched("cos", N2, lr_max, lr_min / 1e4)]
    )
    mom = np.concatenate(
        [get_sched("linear", N1, mom_max, mom_min), get_sched("cos", N2, mom_min, mom_max)]
    )
    beta1 = np.concatenate(
        [get_sched("linear", N1, beta_max, beta_min), get_sched("cos", N2, beta_min, beta_max)]
    )
    return {"lr": lr, "mom": mom, "beta1": beta1}


def cycles_sched(
    steps_per_epoch: int,
    lr_start,
    lr_end,
    num_cycles: int,
    cycle_type: str = "cos",
    base_length: int = 1,
    cycle_mult: int = 1,
) -> np.ndarray:
    """SGDR-style annealing with warm restarts (Learner.py:761-771): each cycle
    anneals lr_start → lr_end over ``steps_per_epoch * cycle_length`` steps,
    with cycle_length growing by ``cycle_mult`` after the first cycle."""
    scheds = []
    cycle_length = base_length
    for i in range(num_cycles):
        if i > 0:
            cycle_length *= cycle_mult
        N = steps_per_epoch * cycle_length
        scheds.append(get_sched(cycle_type, N, lr_start, lr_end))
    return np.concatenate(scheds)
