"""Causal flash attention with in-kernel dropout, forward and backward.

Counterpart of ``neuralnetworklibrary_tpu/ops/flash_attention.py``.  On CUDA
tensors :func:`flash_attention` is a ``torch.autograd.Function`` over three
hand-written Hopper kernels in ``csrc/flash_attention.cu``: the forward
(:func:`flash_fwd`, replacing the Pallas ``_fwd_kernel``) saves ``(o, lse)``;
the backward computes ``delta = rowsum(dO * O)`` as a torch op and launches
the dq kernel (:func:`flash_bwd_dq`, ``_bwd_dq_kernel``) and the dk/dv
kernel (:func:`flash_bwd_dkv`, ``_bwd_dkv_kernel``).  On CPU tensors it runs
:func:`reference_flash_attention`, the plain einsum version of the same
function, which autograd differentiates.  There is no other fallback: an
option the kernels do not take yet raises ``NotImplementedError`` on a CUDA
tensor.

Dropout follows the JAX kernels exactly: the keep mask is the murmur3 hash
:func:`drop_keep` of (seed, b*H + h, query position, key position), it
scales only the value accumulation by 1/(1 - rate) while the softmax
normalizer sums the undropped probabilities, and the backward regenerates
it.  The same int32 seed gives the same mask in both packages, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_TODO = "not in the CUDA kernels yet (ROADMAP Queue 2, K1-K4)"


@functools.cache
def _lib():
    from neuralnetworklibrary_tpu_torch.kernels.build import load

    lib = load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, o, lse; B, T, H, hd; sm_scale, window, rate, seed, dtype; stream
    lib.nnl_flash_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, f, i, i, p]
    # q, k, v, do, lse, delta, dq; B, T, H, hd; sm_scale, window, rate,
    # seed, dtype; stream
    lib.nnl_flash_bwd_dq.argtypes = [p] * 7 + [i] * 4 + [f, i, f, i, i, p]
    # q, k, v, do, lse, delta, dk, dv; then as above
    lib.nnl_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 4 + [f, i, f, i, i, p]
    # seeds, n_seeds, n_bh, n_q, n_k, q0, k0, rate, out, stream
    lib.nnl_flash_drop_keep.argtypes = [p] + [i] * 6 + [f, p, p]
    for fn in (lib.nnl_flash_fwd, lib.nnl_flash_bwd_dq,
               lib.nnl_flash_bwd_dkv, lib.nnl_flash_drop_keep):
        fn.restype = i
    lib.nnl_flash_error_string.argtypes = [i]
    lib.nnl_flash_error_string.restype = ctypes.c_char_p
    return lib


def _int32(seed) -> int:
    """An int (or int tensor) as the int32 it wraps to."""
    return (int(seed) + (1 << 31)) % (1 << 32) - (1 << 31)


# ------------------------------------------------------------ dropout hash

_U32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split so no product
    leaves int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def drop_keep(seed, bh, q_pos, k_pos, rate: float):
    """The keep mask of the JAX ``_drop_keep`` (flash_attention.py:84) for
    broadcastable integer tensors bh, q_pos, k_pos and an int32 seed.

    The JAX hash is int32 arithmetic that wraps, with logical right
    shifts; here every value is its uint32 bit pattern held in int64, so
    the shifts are logical and the products are reduced mod 2**32 by
    :func:`_mul32`.
    """
    seed = _int32(seed) & _U32
    x = (_mul32(q_pos.long() & _U32, 2654435769)
         ^ _mul32(k_pos.long() & _U32, 40503)
         ^ _mul32(bh.long() & _U32, 97531) ^ seed)
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822507)        # int32 -2048144789
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489909)        # int32 -1028477387
    x = x ^ (x >> 16)
    u = (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    return u >= torch.tensor(rate, dtype=torch.float32, device=u.device)


def _keep_grid(seed, B, H, T, rate, device):
    """(B, H, T, T) keep mask of the kernels for a (B, T, H, hd) call."""
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    pos = torch.arange(T, device=device)
    return drop_keep(seed, bh, pos[:, None], pos[None, :], rate)


# ------------------------------------------------------------ plain version


def reference_flash_attention(q, k, v, sm_scale=None, window: int = 0,
                              causal: bool = True, dropout: float = 0.0,
                              dropout_seed=None, bias=None, sink=None,
                              kv_mask=None, q_start=None,
                              return_lse: bool = False):
    """The plain version: materialize (B, H, T, T) scores, mask, softmax,
    drop with the kernels' mask, and contract with v.  (B, T, H, hd) in
    and out, computed in q's dtype; autograd gives its backward.

    Takes every option of the JAX ``flash_attention``: ``bias`` (H, T, T)
    or (1, H, T, T) added after the scale, ``sink`` (H,) joining each
    softmax row's normalizer only, ``kv_mask`` (B, T) bool (False = never
    attended), ``q_start`` (B, T) document starts of packed rows.  A row
    with every key masked attends uniformly, as in JAX.  ``return_lse``
    also returns the (B, H, T) logsumexp the kernels save (sink included).
    """
    B, T, H, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if bias is not None:
        s = s + (bias if bias.ndim == 4 else bias[None]).to(s.dtype)
    pos = torch.arange(T, device=q.device)
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device)
    if causal:
        keep = pos[:, None] >= pos[None, :]
        if window > 0:
            keep = keep & (pos[:, None] - pos[None, :] < window)
    keep = keep[None, None]
    if kv_mask is not None:
        keep = keep & kv_mask.bool()[:, None, None, :]
    if q_start is not None:
        keep = keep & (pos[None, None, None, :]
                       >= q_start.long()[:, None, :, None])
    s = s.masked_fill(~keep, _NEG_INF)
    if sink is not None:
        s = torch.cat([s, sink.to(s.dtype)[None, :, None, None].expand(
            B, H, T, 1)], dim=-1)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if sink is not None:
        p = p[..., :-1]
    if dropout > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout > 0 needs dropout_seed= (an int32)")
        p = p * (_keep_grid(dropout_seed, B, H, T, dropout, q.device)
                 .to(p.dtype) / (1.0 - dropout))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return (o, lse) if return_lse else o


# ------------------------------------------------------------ kernels


def _check(named: dict, dtype, device):
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name in ("lse", "delta") else dtype
        if t.dtype != want:
            raise ValueError(f"{name} dtype {t.dtype} != {want}")


def _run(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + _lib().nnl_flash_error_string(err).decode())


def _shape_args(q, sm_scale, window, dropout, seed):
    B, T, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim {_HEAD_DIMS}, "
                         f"got {hd}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    return (B, T, H, hd, float(sm_scale), int(window), float(dropout),
            _int32(seed or 0), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, sm_scale, window=0, dropout=0.0, seed=0):
    """K1: (o, lse) for contiguous CUDA (B, T, H, hd) q/k/v; lse is
    (B*H, T) float32.  ``flash_fwd.launches`` counts launches."""
    _check({"k": k, "v": v, "q": q}, q.dtype, q.device)
    args = _shape_args(q, sm_scale, window, dropout, seed)
    B, T, H = q.shape[:3]
    o = torch.empty_like(q)
    lse = torch.empty(B * H, T, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _run(_lib().nnl_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), *args)
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale, window=0, dropout=0.0,
                 seed=0):
    """K2: dq from the saved lse and delta = rowsum(dO * O), both (B*H, T)
    float32.  ``flash_bwd_dq.launches`` counts launches."""
    _check({"k": k, "v": v, "do": do, "lse": lse, "delta": delta},
           q.dtype, q.device)
    args = _shape_args(q, sm_scale, window, dropout, seed)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _run(_lib().nnl_flash_bwd_dq, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), *args)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale, window=0, dropout=0.0,
                  seed=0):
    """K3: (dk, dv), with the same inputs as :func:`flash_bwd_dq`.
    ``flash_bwd_dkv.launches`` counts launches."""
    _check({"k": k, "v": v, "do": do, "lse": lse, "delta": delta},
           q.dtype, q.device)
    args = _shape_args(q, sm_scale, window, dropout, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _run(_lib().nnl_flash_bwd_dkv, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), *args)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def kernel_drop_keep(seeds, n_bh: int, n_q: int, n_k: int, rate: float,
                     q0: int = 0, k0: int = 0):
    """The kernels' own hash over a grid on the card: (S, n_bh, n_q, n_k)
    bool for the int32 CUDA tensor ``seeds`` (S,), positions q0 + i and
    k0 + j.  For checking :func:`drop_keep` bit for bit."""
    _check({"seeds": seeds}, torch.int32, seeds.device)
    out = torch.empty(seeds.numel(), n_bh, n_q, n_k, dtype=torch.uint8,
                      device=seeds.device)
    with torch.cuda.device(seeds.device):
        _run(_lib().nnl_flash_drop_keep, seeds.data_ptr(), seeds.numel(),
             n_bh, n_q, n_k, q0, k0, float(rate), out.data_ptr(),
             torch.cuda.current_stream(seeds.device).cuda_stream)
    return out.bool()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, window, dropout, seed):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, sm_scale, window, dropout, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, window, dropout, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        B, T, H, _ = q.shape
        delta = ((do.float() * o.float()).sum(-1)      # (B, T, H)
                 .transpose(1, 2).reshape(B * H, T).contiguous())
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, sm_scale=None, window: int = 0,
                    causal: bool = True, dropout: float = 0.0,
                    dropout_seed=None, bias=None, sink=None, kv_mask=None,
                    q_start=None):
    """Causal attention over (B, T, H, hd) q/k/v -> (B, T, H, hd), on the
    inputs' device; differentiable.

    ``window`` > 0 lets query t see keys (t - window, t].  ``dropout`` in
    (0, 1) drops attention probabilities with the hash mask of seed
    ``dropout_seed`` (an int32, or anything ``int()`` takes).  T is any
    length.  On CUDA tensors the kernels take float32 or bfloat16 and head
    dims 64 and 128; ``causal=False``, ``bias``, ``sink``, ``kv_mask`` and
    ``q_start`` raise NotImplementedError there (the CPU plain version
    takes them all).
    """
    B, T, H, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, T, H, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window > 0 and not causal:
        raise ValueError("window banding requires causal attention")
    if dropout > 0.0:
        if not 0.0 < dropout < 1.0:
            raise ValueError(f"dropout must lie in (0, 1), got {dropout}")
        if dropout_seed is None:
            raise ValueError("dropout > 0 needs dropout_seed= (an int32)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return reference_flash_attention(
            q, k, v, sm_scale, window, causal, dropout, dropout_seed,
            bias=bias, sink=sink, kv_mask=kv_mask, q_start=q_start)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    for name, val in (("causal=False", not causal), ("bias", bias),
                      ("sink", sink), ("kv_mask", kv_mask),
                      ("q_start", q_start)):
        if val is not None and val is not False:
            raise NotImplementedError(f"flash_attention: {name} is {_TODO}")
    return _FlashAttention.apply(q, k, v, float(sm_scale), int(window),
                                 float(dropout),
                                 _int32(dropout_seed or 0))
