"""The cross-entropy of each row of a logit matrix, in one pass over the
logits forward and one backward.

Not a port of a TPU kernel: the JAX package leaves its loss to XLA, which
fuses the log-softmax, the gather of the target and their backward.
:func:`cross_entropy` gives each row's ``nll = logsumexp(x) - x[target]``
in float32 from logits in the model's own dtype, and its gradient
``(softmax(x) - onehot(target)) * dnll`` in that dtype.  On a CUDA device
both passes are the hand-written kernels of ``csrc/cross_entropy.cu``
(float32 and bf16 logits), which read the logits where they lie, rows any
stride apart, and keep one float32 a row (the log-sum-exp) for the
backward.  On the CPU the same two passes run in PyTorch (the plain
version); a CUDA tensor never takes them.

The weighting of a loss (a row mask, pad targets, the mean's divisor)
stays with the caller, as PyTorch arithmetic on the N floats of ``nll``;
its gradient reaches the backward as ``dnll``, on the device.

The gradient takes the logits' row layout: where their rows are ``ld >
V`` elements apart (the padded head's view, ``ops/padded_head.py``), it is
the (..., V) view of an (N, ld) buffer whose other ``ld - V`` columns are
not written, which the padded head's backward then takes as its own
padded buffer instead of copying the gradient into one.
"""

from __future__ import annotations

import ctypes

import torch

from neuralnetworklibrary_tpu_torch.kernels import build

# the kernels' dtype codes (csrc/cross_entropy.cu kF32, kBf16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # x, dtype, n, v, ld, target, lse, nll, stream
    "nnl_cross_entropy_fwd": ([_P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    # x, dtype, n, v, ld, target, lse, dnll, dx, ldd, stream
    "nnl_cross_entropy_bwd": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
                              _I),
    "nnl_cross_entropy_error_string": ([_I], ctypes.c_char_p),
}


# the kernels take the row count, the row length and the row stride as C
# ints
LD_LIMIT = 2 ** 31


def rows(logits):
    """``logits`` (..., V) as an (N, V) matrix of adjacent elements whose
    rows are ``V <= ld < LD_LIMIT`` elements apart: a view where the
    leading dimensions merge into rows of one such stride, else a
    contiguous copy.  Returns ``(matrix, ld)``."""
    V = logits.shape[-1]
    x = logits.reshape(-1, V)
    if x.shape[0] < 2:
        return x.contiguous(), V
    if x.stride(1) != 1 or not V <= x.stride(0) < LD_LIMIT:
        x = x.contiguous()
    return x, x.stride(0)


def _plain_forward(x, t):
    """(lse, nll) of the rows of ``x`` against ``t``, in float32 (float64
    logits stay float64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    lse = torch.logsumexp(xf, dim=-1)
    return lse, lse - xf.gather(1, t[:, None])[:, 0]


def _plain_backward(x, t, lse, dnll, out):
    """Write ``(softmax(x) - onehot(t)) * dnll`` into ``out`` (N, V) in its
    dtype."""
    g = x.to(lse.dtype, copy=True).sub_(lse[:, None]).exp_()
    g.mul_(dnll[:, None]).scatter_add_(1, t[:, None], -dnll[:, None])
    out.copy_(g)


def _launch(entry, x, *args):
    if not x.numel():
        return
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check_call("cross_entropy", SIGNATURES, entry, *args, stream)
    cross_entropy.launches += 1


def _checked(x, t):
    if x.device.type == "cuda" and x.dtype not in DTYPES:
        raise ValueError(f"cross_entropy: the kernel takes float32 or "
                         f"bfloat16 logits on {x.device}, not {x.dtype}")
    if t.device != x.device:
        raise ValueError(f"cross_entropy: targets on {t.device}, logits on "
                         f"{x.device}")
    if x.shape[0] >= LD_LIMIT or x.shape[1] >= LD_LIMIT:
        raise ValueError(f"cross_entropy: {tuple(x.shape)} rows by logits "
                         f"pass the kernel's 32-bit counts")


class _CrossEntropy(torch.autograd.Function):
    """nll (N,) of the (N, V) matrix ``x`` (from :func:`rows`) against
    int64 targets ``t`` (N,); saves ``x``, ``t`` and the log-sum-exp."""

    @staticmethod
    def forward(ctx, x, t, ld):
        _checked(x, t)
        N, V = x.shape
        if x.device.type == "cuda":
            lse = torch.empty(N, dtype=torch.float32, device=x.device)
            nll = torch.empty_like(lse)
            _launch("nnl_cross_entropy_fwd", x, x.data_ptr(), DTYPES[x.dtype],
                    N, V, ld, t.data_ptr(), lse.data_ptr(), nll.data_ptr())
        else:
            lse, nll = _plain_forward(x, t)
        ctx.save_for_backward(x, t, lse)
        ctx.ld = ld
        return nll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dnll):
        x, t, lse = ctx.saved_tensors
        N, V = x.shape
        ld = ctx.ld
        # the gradient in the logits' row layout: columns V..ld unwritten
        buf = torch.empty((N, ld), dtype=x.dtype, device=x.device)
        dx = buf[:, :V]
        dnll = dnll.to(lse.dtype).contiguous()
        if x.device.type == "cuda":
            _launch("nnl_cross_entropy_bwd", x, x.data_ptr(),
                    DTYPES[x.dtype], N, V, ld, t.data_ptr(), lse.data_ptr(),
                    dnll.data_ptr(), buf.data_ptr(), ld)
        else:
            _plain_backward(x, t, lse, dnll, dx)
        return dx, None, None


def cross_entropy(logits, target):
    """Each row's ``logsumexp(logits) - logits[target]``: logits (..., V)
    in float32 or bf16 (the CPU also takes other float dtypes), integer
    targets (...) in [0, V); returns float32 (...) (float64 for float64
    logits), differentiable in the logits.  On a CUDA device both passes
    are the kernels (``cross_entropy.launches`` counts their launches); a
    target outside [0, V) gives a NaN there and raises on the CPU."""
    if tuple(target.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"cross_entropy: targets of shape "
                         f"{tuple(target.shape)} for logits of shape "
                         f"{tuple(logits.shape)}")
    x, ld = rows(logits)
    t = target.reshape(-1).to(torch.int64).contiguous()
    return _CrossEntropy.apply(x, t, ld).view(target.shape)


cross_entropy.launches = 0
