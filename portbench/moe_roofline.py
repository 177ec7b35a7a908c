"""The least time of an expert layer's grouped products: the gate, up and
down products of the held experts, forward, dX and dW, over the
assignments they held.

Peaks as ``roofline.py`` (the H100 SXM data sheet, 700 W).  FLOPs: 2 D F
a product and assignment, 3 products, each run forward, for dX and for
dW: 18 D F an assignment.  Bytes, each read or written once: the held
experts' weights (3 E D F) read by the forward, read by dX and written
as dW; the rows: the gathered inputs read by the forward and by dW, the
outputs written, the output gradients read, the input gradients written
(5 A D); elements of ``dtype``.  Biases and routing weights are left out
(under 0.5% of either count at the benchmark's sizes).
"""

from __future__ import annotations

from portbench.roofline import HBM_BYTES_PER_S, PEAK_FLOPS


def expert_flops(assignments: float, D: int, F: int) -> float:
    """FLOPs of the forward, dX and dW of the three products."""
    return 18.0 * D * F * assignments


def expert_bytes(assignments: float, layers: int, E: int, D: int, F: int,
                 dtype: str = "bfloat16") -> float:
    """Bytes moved once: ``layers`` layers' held weights (read twice,
    written once) and the assignments' rows (five times)."""
    elem = 2 if dtype == "bfloat16" else 4
    return elem * (3 * 3 * E * D * F * layers + 5 * D * assignments)


def expert_least_seconds(assignments: float, layers: int, E: int, D: int,
                         F: int, dtype: str = "bfloat16") -> float:
    """The larger of the FLOPs over the peak and the bytes over the HBM
    rate, for ``assignments`` summed over ``layers`` expert layers."""
    return max(expert_flops(assignments, D, F) / PEAK_FLOPS[dtype],
               expert_bytes(assignments, layers, E, D, F, dtype)
               / HBM_BYTES_PER_S)
