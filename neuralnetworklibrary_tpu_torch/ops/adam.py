"""One Adam step over lists of float32 CUDA tensors in one pass.

Not a port of a TPU kernel: the JAX package leaves its optimizer to XLA,
which fuses each leaf's update.  :func:`adam` launches the hand-written
kernel in ``csrc/adam.cu``, which reads p, g, m and v once and writes p, m
and v once (28 bytes an element), with no temporaries.
``core/optim.py`` ``Optimizer.apply`` sends every trained leaf of the
adam kind through it where the parameters are on a CUDA device; on the
CPU it keeps its foreach chain, the plain version of the same arithmetic.

A launch's tensors travel by value in the kernel's parameter space (the
``Table`` of ``csrc/adam.cu``), at most ``MAX_TENSORS`` of them; the work
is cut into units of ``CHUNK`` elements of one tensor, numbered through
the tensors in order.  :func:`plan` cuts a list into launches and
:func:`unit_span` finds a unit's elements as the kernel does, both in
plain Python, for the tests.
"""

from __future__ import annotations

import bisect
import ctypes

import torch

from neuralnetworklibrary_tpu_torch.kernels import build

# constants of csrc/adam.cu (kMaxTensors, kChunk), which the card test
# holds against the library's nnl_adam_layout
MAX_TENSORS = 80
CHUNK = 8192
# work units a launch may number: the kernel counts them in a 32-bit int
MAX_UNITS = 2 ** 30

_P, _F = ctypes.c_void_p, ctypes.c_float
SIGNATURES = {
    # table; lr, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps; scale; stream
    "nnl_adam": ([_P] + [_F] * 8 + [_P, _P], ctypes.c_int),
    # out: (MAX_TENSORS, CHUNK, sizeof(Table))
    "nnl_adam_layout": ([_P], None),
    "nnl_adam_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class Table(ctypes.Structure):
    """``Table`` of ``csrc/adam.cu``: one launch's tensors."""

    _fields_ = [("p", _P * MAX_TENSORS), ("g", _P * MAX_TENSORS),
                ("m", _P * MAX_TENSORS), ("v", _P * MAX_TENSORS),
                ("numel", ctypes.c_int64 * MAX_TENSORS),
                ("first", ctypes.c_int * (MAX_TENSORS + 1)),
                ("decay", _F * MAX_TENSORS), ("n", ctypes.c_int)]


def layout() -> tuple:
    """The kernel library's (MAX_TENSORS, CHUNK, table bytes)."""
    out = (ctypes.c_int * 3)()
    build.bind("adam", SIGNATURES).nnl_adam_layout(out)
    return tuple(out)


def plan(numels) -> list:
    """Launches for tensors of ``numels`` elements, in order: each a list of
    ``(index, first unit)`` and, last, the launch's unit count.  A launch
    holds at most ``MAX_TENSORS`` tensors and ``MAX_UNITS`` units; empty
    tensors take none."""
    launches, cur, units = [], [], 0
    for i, n in enumerate(numels):
        need = -(-n // CHUNK)
        if need == 0:
            continue
        if need > MAX_UNITS:
            raise ValueError(f"adam: a tensor of {n} elements takes more "
                             f"than {MAX_UNITS} units of {CHUNK}")
        if len(cur) == MAX_TENSORS or units + need > MAX_UNITS:
            launches.append((cur, units))
            cur, units = [], 0
        cur.append((i, units))
        units += need
    if cur:
        launches.append((cur, units))
    return launches


def unit_span(entries, numels, c: int) -> tuple:
    """``(index, start, stop)``: the elements of work unit ``c`` of the
    launch ``entries`` (from :func:`plan`), found as the kernel finds them
    (the last tensor whose first unit is at most ``c``)."""
    k = bisect.bisect_right([f for _, f in entries], c) - 1
    i, first = entries[k]
    start = (c - first) * CHUNK
    return i, start, min(start + CHUNK, numels[i])


def _dense(t) -> bool:
    """Whether ``t``'s elements fill ``numel`` consecutive slots, in some
    order of its dimensions (contiguous, or channels_last as the vision
    models keep their convolutions)."""
    if t.is_contiguous():
        return True
    want = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda d: d[1]):
        if size != 1:
            if stride != want:
                return False
            want *= size
    return True


def _takes(p, g, m, v, device) -> bool:
    """Whether p, g, m and v are float32 on ``device``, of one shape and
    one dense layout, so that one flat index reaches the same element in
    each.  (Called for every leaf of every step: the cheap tests first.)"""
    return (p.dtype is g.dtype is m.dtype is v.dtype is torch.float32
            and p.shape == g.shape == m.shape == v.shape
            and p.device == g.device == m.device == v.device == device
            and (p.is_contiguous() and g.is_contiguous()
                 and m.is_contiguous() and v.is_contiguous()
                 or p.stride() == g.stride() == m.stride() == v.stride()
                 and _dense(p)))


def adam(ps, gs, ms, vs, decays, *, lr, b1, omb1, b2, omb2, bc1, bc2, eps,
         scale=None):
    """One Adam step, in place, over the parameters ``ps`` with gradients
    ``gs`` and moments ``ms``, ``vs``: float32 tensors on one CUDA device,
    each leaf's four of one shape and one dense layout (raises otherwise).
    ``p *= decay`` (per tensor), ``g' = g * scale`` (a float32 device
    scalar, or None), the moments' update and the bias-corrected step.
    Every other argument is a float32 value of the foreach chain's
    (``omb1`` = 1 - b1, ``omb2`` = 1 - b2, ``bc1``/``bc2`` the bias
    corrections).  The gradients are not written.  ``adam.launches``
    counts the kernel's launches and ``adam.elements`` the elements they
    updated."""
    if not (len(ps) == len(gs) == len(ms) == len(vs) == len(decays)):
        raise ValueError("adam: p, g, m, v and decays differ in length")
    if not ps:
        return
    device = ps[0].device
    for p, g, m, v in zip(ps, gs, ms, vs):
        if not _takes(p, g, m, v, device):
            raise ValueError(
                f"adam: p, g, m and v must be float32 tensors of one shape "
                f"and dense layout on {device}; got {p.dtype}/{g.dtype}/"
                f"{m.dtype}/{v.dtype} of strides {p.stride()}/{g.stride()}/"
                f"{m.stride()}/{v.stride()} on {p.device}/{g.device}/"
                f"{m.device}/{v.device}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.device != device
                              or scale.numel() != 1):
        raise ValueError("adam: scale must be a float32 scalar on the "
                         "tensors' device")
    if device.type != "cuda":
        raise ValueError(f"adam: the kernel runs on CUDA tensors, not on "
                         f"{device}")
    scalars = (lr, b1, omb1, b2, omb2, bc1, bc2, eps)
    numels = [p.numel() for p in ps]
    ptrs = [[t.data_ptr() for t in ts] for ts in (ps, gs, ms, vs)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for entries, units in plan(numels):
            t, n = Table(), len(entries)
            idx = [i for i, _ in entries]
            for field, ts in zip(("p", "g", "m", "v"), ptrs):
                getattr(t, field)[:n] = [ts[i] for i in idx]
            t.numel[:n] = [numels[i] for i in idx]
            t.first[:n + 1] = [f for _, f in entries] + [units]
            t.decay[:n] = [decays[i] for i in idx]
            t.n = n
            build.check_call(
                "adam", SIGNATURES, "nnl_adam", ctypes.byref(t), *scalars,
                None if scale is None else scale.data_ptr(), stream)
            adam.launches += 1
            adam.elements += sum(numels[i] for i in idx)


adam.launches = 0
adam.elements = 0
