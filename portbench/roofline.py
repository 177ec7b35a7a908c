"""The yardstick's arithmetic: the card's peaks, the attended (query, key)
pairs of a batch, the least time of the attention call, and a model's
FLOPs per token.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assume the full 700 W; ``device`` in every result line gives the card's
name and power limit beside them.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def doc_starts(x: np.ndarray, separator) -> np.ndarray:
    """(B, T) int64: each position's document start, where a document
    starts right after each separator; all 0 when ``separator`` is None
    (one causal run over the row).  Origin: ``chip_smoke.py``
    ``qwen3_starts``, with the separator an argument."""
    B, T = x.shape
    if separator is None:
        return np.zeros((B, T), np.int64)
    sep = np.zeros((B, T), bool)
    sep[:, 1:] = x[:, :-1] == separator
    idx = np.arange(T)
    return np.maximum.accumulate(np.where(sep, idx, 0), axis=1)


def keys_per_position(x: np.ndarray, separator) -> np.ndarray:
    """(B, T) int64: how many keys each query attends under causal
    attention within its document."""
    return np.arange(x.shape[1]) - doc_starts(x, separator) + 1


def attention_least_seconds(pairs: int, B: int, T: int, H: int, Hkv: int,
                            hd: int, packed: bool,
                            dtype: str = "bfloat16") -> float:
    """Least time of one layer's attention forward and backward over
    ``pairs`` attended (query, key) pairs of one head (summed over the
    batch), with H query heads over Hkv key and value heads of width hd.

    FLOPs: the forward's QK^T and PV (4 hd a pair and query head), the
    backward's recomputed S, dP, dV, dQ and dK (10 hd): 14 hd.  Bytes:
    q and dO read once, o and dq written once ((B, T, H, hd) each), k and
    v read once, dk and dv written once ((B, T, Hkv, hd) each), 2 bytes
    an element in bf16; the forward's log-sum-exp and the backward's
    delta, one float32 each a row and query head, read by the backward;
    and the (B, T) int32 document starts of packed rows.  The larger of
    FLOPs over the peak and bytes over the HBM rate, in seconds; it
    counts the whole call, not a kernel, so a change that fuses or splits
    kernels reads against the same work.  Origin: ``chip_smoke.py``
    ``flash_bound``, which counts each kernel of the call on its own."""
    flops = 14 * hd * pairs * H
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = ((4 * H + 4 * Hkv) * B * T * hd * elem + 2 * B * H * T * 4
              + (B * T * 4 if packed else 0))
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def model_flops(keys: np.ndarray, weights: np.ndarray, n_matmul: int,
                L: int, H: int, hd: int) -> float:
    """Model FLOPs of the tokens with ``weights`` 1 (the loss-bearing
    ones): per token 6 x ``n_matmul`` (the non-embedding matrices and the
    tied head) plus 12 L H hd x its attended keys (forward and backward
    of QK^T and PV).  Recomputation is not counted."""
    n = float(weights.sum())
    k = float((keys * weights).sum())
    return 6.0 * n_matmul * n + 12.0 * L * H * hd * k
