"""Flash attention with in-kernel dropout, forward and backward.

Counterpart of ``neuralnetworklibrary_tpu/ops/flash_attention.py``.  On CUDA
tensors :func:`flash_attention` is a ``torch.autograd.Function`` over the
hand-written Hopper kernels in ``csrc/flash_attention.cu``: the forward
(:func:`flash_fwd`, replacing the Pallas ``_fwd_kernel``) saves ``(o, lse)``;
the backward computes ``delta = rowsum(dO * O)`` as a torch op and launches
the dq kernel (:func:`flash_bwd_dq`, ``_bwd_dq_kernel``) and the dk/dv
kernel (:func:`flash_bwd_dkv`, ``_bwd_dkv_kernel``), or, when a bias needs
its gradient, one call that also gives dbias (:func:`flash_bwd_dkv_dbias`,
replacing ``_bwd_dkv_kernel`` and ``_bwd_dbias_kernel`` together).  The
kernels take causal or bidirectional attention, a causal window, a
batch-shared (H, T, T) logit bias, a (B, T) key mask, packed rows as a
(B, T) document start per query (``q_start``: query t sees key s only if
s >= q_start[b, t], causal only), a per-head sink logit in the forward's
normalizer (``sink``), and head dims 64 and 128.  On bfloat16 the forward, dq and dk/dv kernels run on the tensor
cores (wgmma, fed by TMA, so q, k, v and dO must start on 16-byte
boundaries), and dbias comes out of the dk/dv kernel's pass: it writes
each batch row's dS to a scratch that a second kernel sums over the batch
in a fixed order (no atomics, so two runs give the same bits).  On float32
the kernels compute in float32 on the CUDA cores.  A kernel that fails to
build or launch raises.  On CPU tensors it runs
:func:`reference_flash_attention`, the plain einsum version of the same
function, which autograd differentiates.  There is no other fallback: a
head dim the kernels do not take raises ``ValueError``.  Models choose the
flash path for a call only where the kernels take it (:func:`use_flash`).

The sink's gradient needs no kernel: with the sink inside the saved lse,
dsink[h] = -sum over b, t of exp(sink[h] - lse[b, h, t]) * delta[b, h, t],
a torch op on the residuals, as the JAX package computes it
(flash_attention.py:32-37).

The key mask enters the kernels additively, -1e30 on a masked key, as in
JAX, so a row whose every key is masked attends uniformly over the keys its
position lets it see.  Its gradient is the plain version's, whose masked
scores are replaced rather than offset: no gradient reaches q, k or the
bias through a masked key.

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

from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.utils import tracing

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B, T, H, hd; sm_scale, causal, window, rate, seed, dtype; stream
_TAIL = [_I] * 4 + [_F, _I, _I, _F, _I, _I, _P]
# (argtypes, restype) of every C entry point of csrc/flash_attention.cu
SIGNATURES = {
    # q, k, v, bias, kvm, qs, sink, o, lse
    "nnl_flash_fwd": ([_P] * 9 + _TAIL, _I),
    # q, k, v, do, lse, delta, bias, kvm, qs, dq
    "nnl_flash_bwd_dq": ([_P] * 10 + _TAIL, _I),
    # q, k, v, do, lse, delta, bias, kvm, qs, dk, dv
    "nnl_flash_bwd_dkv": ([_P] * 11 + _TAIL, _I),
    # q, k, v, do, lse, delta, bias, kvm, qs, dk, dv, dbias, part
    "nnl_flash_bwd_dkv_dbias": ([_P] * 13 + _TAIL, _I),
    # seeds, n_seeds, n_bh, n_q, n_k, q0, k0, rate, out, stream
    "nnl_flash_drop_keep": ([_P] + [_I] * 6 + [_F, _P, _P], _I),
    "nnl_flash_error_string": ([_I], ctypes.c_char_p),
}
_run = functools.partial(build.check_call, "flash_attention", SIGNATURES)


def use_flash(flash_attention, device_type: str, dtype,
              head_dim: int) -> bool:
    """The models' choice of the flash path for a full-sequence forward.

    ``flash_attention`` True or False is taken as given (True on a shape
    the kernels do not take then raises in the kernels' wrapper).  None
    (auto) picks flash exactly where the CUDA kernels take the call (a
    CUDA device, float32 or bfloat16, head dim 64 or 128; sinks and
    packed rows included) and the model's own einsum path everywhere
    else, as the JAX models' auto rule picks einsum where its kernels are
    not the choice.  ``dtype`` is the type attention computes in:
    autocast's on ``device_type`` where autocast is on, else the given
    one."""
    if flash_attention is not None:
        return bool(flash_attention)
    if torch.is_autocast_enabled(device_type):
        dtype = torch.get_autocast_dtype(device_type)
    return (device_type == "cuda" and dtype in _DTYPE_CODE
            and head_dim in _HEAD_DIMS)


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
    attended), ``q_start`` (B, T) document starts of packed rows.  Masked
    keys' scores become -1e30, so a row with every key masked attends
    uniformly, as in JAX, over the keys its position lets it see (causal,
    window and document starts remove keys outright).  ``return_lse``
    also returns the (B, H, T) logsumexp the kernels save (sink included).
    """
    B, T, H, hd = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if bias is not None:
        s = s + (bias if bias.ndim == 4 else bias[None]).to(s.dtype)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], _NEG_INF)
    pos = torch.arange(T, device=q.device)
    seen = None    # what each query sees by position
    if causal:
        seen = pos[:, None] >= pos[None, :]
        if window > 0:
            seen = seen & (pos[:, None] - pos[None, :] < window)
    if q_start is not None:
        docs = pos[None, None, None, :] >= q_start.long()[:, None, :, None]
        seen = docs if seen is None else seen & docs
    if seen is not None:
        s = s.masked_fill(~seen, float("-inf"))
    if sink is not None:
        s = torch.cat([s, sink.to(s.dtype)[None, :, None, None].expand(
            B, H, T, 1)], dim=-1)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if sink is not None:
        p = p[..., :-1]
    if dropout > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout > 0 needs dropout_seed= (an int32)")
        p = p * (_keep_grid(dropout_seed, B, H, T, dropout, q.device)
                 .to(p.dtype) / (1.0 - dropout))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return (o, lse) if return_lse else o


def reference_dkv_dbias(q, k, v, do, lse, delta, sm_scale, window=0,
                        dropout=0.0, seed=0, *, causal=True, bias=None,
                        kvm=None, qs=None):
    """The plain version of K3's pass, in float32, from the saved lse and
    delta as the kernels take them (same arguments as
    :func:`flash_bwd_dkv_dbias`): (dk, dv, ds), dk and dv in q's dtype and
    ds the (B, H, T, T) float32 dS = P * (dP - delta) of every batch row.
    :func:`flash_bwd_dkv_dbias` sums ds over the batch for dbias.

    P is exp(s - lse) of the scaled score plus bias and additive key mask,
    or 1/n over the n keys a fully masked row (lse -1e30) sees by
    position and document start (``qs``, (B, T) or None); dS is 0 on a
    masked key and P and dS 0 on a pair the position does not attend.  dV takes P times the dropout keep mask over
    (1 - rate), and dP the same mask."""
    B, T, H, _ = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if kvm is not None:
        s = s + kvm.float()[:, None, None, :]
    pos = torch.arange(T, device=q.device)
    seen = torch.ones(T, T, dtype=torch.bool, device=q.device)
    if causal:
        seen = pos[:, None] >= pos[None, :]
        if window > 0:
            seen = seen & (pos[:, None] - pos[None, :] < window)
    if qs is not None:
        seen = seen & (pos[None, None, None, :]
                       >= qs.long()[:, None, :, None])
    lse = lse.reshape(B, H, T, 1)
    n = seen.sum(-1, keepdim=True).float()
    p = torch.where(lse <= -1e29, 1.0 / n, torch.exp(s - lse))
    p = torch.where(seen, p, torch.zeros((), device=q.device))
    m = 1.0
    if dropout > 0.0:
        m = (_keep_grid(seed, B, H, T, dropout, q.device).float()
             / (1.0 - dropout))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf) * m
    ds = p * (dp - delta.reshape(B, H, T, 1))
    if kvm is not None:
        ds = ds.masked_fill((kvm != 0)[:, None, None, :], 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p * m, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    return dk.to(q.dtype), dv.to(q.dtype), ds


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
        if want == torch.bfloat16 and t.data_ptr() % 16:
            # K1 and K2 read bf16 rows by TMA (rows are H * hd * 2 bytes
            # apart, a multiple of 128 for the head dims they take)
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"for the bf16 kernels")


def _shape_args(q, sm_scale, causal, window, dropout, seed):
    B, T, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim {_HEAD_DIMS}, "
                         f"got {hd}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    return (B, T, H, hd, float(sm_scale), int(bool(causal)), int(window),
            float(dropout), _int32(seed or 0), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _option_ptrs(q, bias, kvm, qs):
    """Pointers of the (H, T, T) bias and the (B, T) additive key mask, both
    float32, and the (B, T) int32 document starts, each contiguous on q's
    device, or None."""
    B, T, H, _ = q.shape
    for name, t, shape, dtype in (("bias", bias, (H, T, T), torch.float32),
                                  ("kvm", kvm, (B, T), torch.float32),
                                  ("qs", qs, (B, T), torch.int32)):
        if t is None:
            continue
        _check({name: t}, dtype, q.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return tuple(None if t is None else t.data_ptr() for t in (bias, kvm, qs))


def flash_fwd(q, k, v, sm_scale, window=0, dropout=0.0, seed=0, *,
              causal=True, bias=None, kvm=None, qs=None, sink=None):
    """K1: (o, lse) for contiguous CUDA (B, T, H, hd) q/k/v; lse is
    (B*H, T) float32, the sink included.  ``bias`` is a float32 (H, T, T)
    logit bias, ``kvm`` the float32 (B, T) additive key mask (0 or -1e30),
    ``qs`` the int32 (B, T) document starts (causal only), ``sink`` the
    float32 (H,) sink logits, each or None.  ``flash_fwd.launches`` counts
    launches."""
    _check({"k": k, "v": v, "q": q}, q.dtype, q.device)
    args = _shape_args(q, sm_scale, causal, window, dropout, seed)
    B, T, H = q.shape[:3]
    if sink is not None:
        _check({"sink": sink}, torch.float32, q.device)
        if tuple(sink.shape) != (H,):
            raise ValueError(f"sink must be ({H},), got {tuple(sink.shape)}")
    o = torch.empty_like(q)
    lse = torch.empty(B * H, T, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _run("nnl_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             *_option_ptrs(q, bias, kvm, qs),
             None if sink is None else sink.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *args)
    flash_fwd.launches += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _check({"q": q, "k": k, "v": v, "do": do, "lse": lse,
            "delta": delta}, q.dtype, q.device)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale, window=0, dropout=0.0,
                 seed=0, *, causal=True, bias=None, kvm=None, qs=None):
    """K2: dq from the saved lse and delta = rowsum(dO * O), both (B*H, T)
    float32; options as :func:`flash_fwd` (the sink is inside lse).
    ``flash_bwd_dq.launches`` counts launches."""
    ptrs = _bwd_inputs(q, k, v, do, lse, delta)
    args = _shape_args(q, sm_scale, causal, window, dropout, seed)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _run("nnl_flash_bwd_dq", *ptrs,
             *_option_ptrs(q, bias, kvm, qs), dq.data_ptr(), *args)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale, window=0, dropout=0.0,
                  seed=0, *, causal=True, bias=None, kvm=None, qs=None):
    """K3: (dk, dv), with the same inputs as :func:`flash_bwd_dq`.
    ``flash_bwd_dkv.launches`` counts K3's launches, those of
    :func:`flash_bwd_dkv_dbias` included."""
    ptrs = _bwd_inputs(q, k, v, do, lse, delta)
    args = _shape_args(q, sm_scale, causal, window, dropout, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _run("nnl_flash_bwd_dkv", *ptrs,
             *_option_ptrs(q, bias, kvm, qs), dk.data_ptr(), dv.data_ptr(),
             *args)
    flash_bwd_dkv.launches += 1
    return dk, dv


def dbias_rows(T: int) -> int:
    """Rows (and row length) of K3's per-batch dS scratch: T rounded up to
    its 64-row key tiles."""
    return -(-T // 64) * 64


def flash_bwd_dkv_dbias(q, k, v, do, lse, delta, sm_scale, window=0,
                        dropout=0.0, seed=0, *, causal=True, bias, kvm=None,
                        qs=None):
    """K3 and K4 in one call: (dk, dv, dbias), dbias (H, T, T) float32 the
    sum over the batch of P * (dP - delta); the inputs of
    :func:`flash_bwd_dq`, with the bias required.

    bfloat16: K3's pass on the tensor cores also writes each batch row's dS
    (float32) into a (B*H, Tp, Tp) scratch (Tp = :func:`dbias_rows`), and a
    second kernel sums it over the batch in a fixed order; float32: the
    SIMT K3, then the SIMT K4.  Each call counts one launch in
    ``flash_bwd_dkv.launches`` (K3) and one in ``flash_bwd_dbias.launches``
    (the batch sum, or the SIMT K4).  On CPU tensors it runs
    :func:`reference_dkv_dbias` and sums its dS."""
    if bias is None:
        raise ValueError("flash_bwd_dkv_dbias needs the bias")
    if q.device.type == "cpu":
        dk, dv, ds = reference_dkv_dbias(
            q, k, v, do, lse, delta, sm_scale, window, dropout, seed,
            causal=causal, bias=bias, kvm=kvm, qs=qs)
        return dk, dv, ds.sum(0)
    ptrs = _bwd_inputs(q, k, v, do, lse, delta)
    args = _shape_args(q, sm_scale, causal, window, dropout, seed)
    B, T, H, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    part = (torch.empty(B * H * dbias_rows(T) ** 2, dtype=torch.float32,
                        device=q.device)
            if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        _run("nnl_flash_bwd_dkv_dbias", *ptrs,
             *_option_ptrs(q, bias, kvm, qs), dk.data_ptr(), dv.data_ptr(),
             dbias.data_ptr(), None if part is None else part.data_ptr(),
             *args)
    flash_bwd_dkv.launches += 1
    flash_bwd_dbias.launches += 1
    return dk, dv, dbias


def flash_bwd_dbias(q, k, v, do, lse, delta, sm_scale, window=0,
                    dropout=0.0, seed=0, *, causal=True, bias, kvm=None,
                    qs=None):
    """K4: dbias (H, T, T) float32 alone, from :func:`flash_bwd_dkv_dbias`
    (whose dk and dv it drops, and whose launches it counts)."""
    return flash_bwd_dkv_dbias(q, k, v, do, lse, delta, sm_scale, window,
                               dropout, seed, causal=causal, bias=bias,
                               kvm=kvm, qs=qs)[2]


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dbias.launches = 0


def kernel_drop_keep(seeds, n_bh: int, n_q: int, n_k: int, rate: float,
                     q0: int = 0, k0: int = 0):
    """The kernels' own hash over a grid on the card: (S, n_bh, n_q, n_k)
    bool for the int32 CUDA tensor ``seeds`` (S,), positions q0 + i and
    k0 + j.  For checking :func:`drop_keep` bit for bit."""
    _check({"seeds": seeds}, torch.int32, seeds.device)
    out = torch.empty(seeds.numel(), n_bh, n_q, n_k, dtype=torch.uint8,
                      device=seeds.device)
    with torch.cuda.device(seeds.device):
        _run("nnl_flash_drop_keep", seeds.data_ptr(), seeds.numel(),
             n_bh, n_q, n_k, q0, k0, float(rate), out.data_ptr(),
             torch.cuda.current_stream(seeds.device).cuda_stream)
    return out.bool()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, kvm, qs, sink, sm_scale, causal, window,
                dropout, seed):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, bias=bias, kvm=kvm, qs=qs)
        o, lse = flash_fwd(q, k, v, sm_scale, window, dropout, seed,
                           sink=sink, **kw)
        ctx.save_for_backward(q, k, v, o, lse, bias, kvm, qs, sink)
        ctx.args = (sm_scale, window, dropout, seed)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        with tracing.span("attention.bwd"):
            q, k, v, o, lse, bias, kvm, qs, sink = ctx.saved_tensors
            do = do.to(q.dtype).contiguous()
            B, T, H, _ = q.shape
            delta = ((do.float() * o.float()).sum(-1)      # (B, T, H)
                     .transpose(1, 2).reshape(B * H, T).contiguous())
            kw = dict(causal=ctx.causal, bias=bias, kvm=kvm, qs=qs)
            inputs = (q, k, v, do, lse, delta, *ctx.args)
            dq = flash_bwd_dq(*inputs, **kw)
            if ctx.needs_input_grad[3]:
                dk, dv, dbias = flash_bwd_dkv_dbias(*inputs, **kw)
            else:
                (dk, dv), dbias = flash_bwd_dkv(*inputs, **kw), None
            dsink = None
            if ctx.needs_input_grad[6]:
                # the sink's column has v = 0: dsink_h = -sum_{b,t}
                # exp(sink_h - lse) * delta, from the residuals alone
                dsink = -(torch.exp(sink[None, :, None] - lse.view(B, H, T))
                          * delta.view(B, H, T)).sum((0, 2))
            return (dq, dk, dv, dbias, None, None, dsink, None, None, None,
                    None, None)


def flash_attention(q, k, v, sm_scale=None, window: int = 0,
                    causal: bool = True, dropout: float = 0.0,
                    dropout_seed=None, bias=None, sink=None, kv_mask=None,
                    q_start=None):
    """Attention over (B, T, H, hd) q/k/v -> (B, T, H, hd), on the inputs'
    device; differentiable.

    ``causal=False`` is bidirectional.  ``window`` > 0 lets query t see keys
    (t - window, t] (causal only).  ``bias`` is a batch-shared logit bias,
    (H, T, T) or (1, H, T, T), added after the scale in float32 (T5's
    relative positions), with its gradient; a per-batch bias raises
    ValueError, as in JAX.  ``kv_mask`` (B, T) bool: False keys are never
    attended.  ``dropout`` in (0, 1) drops attention probabilities with
    the hash mask of seed ``dropout_seed`` (an int32, or anything ``int()``
    takes).  ``sink`` (H,) is a per-head logit that joins each row's
    softmax normalizer and whose mass is dropped, with its gradient.
    ``q_start`` (B, T) integer, causal only, holds each query's document
    start in packed rows: query t sees key s only if s >= q_start[b, t]
    (any values; ``arange(T) - positions`` for contiguous documents).  T
    is any length.  On CUDA tensors the kernels take float32 or bfloat16
    and head dims 64 and 128 (another raises ValueError).
    """
    with tracing.span("attention.fwd"):
        B, T, H, hd = q.shape
        if k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"q, k, v must share one (B, T, H, hd) shape, "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if window > 0 and not causal:
            raise ValueError("window banding requires causal attention")
        if dropout > 0.0:
            if not 0.0 < dropout < 1.0:
                raise ValueError(f"dropout must lie in (0, 1), got {dropout}")
            if dropout_seed is None:
                raise ValueError("dropout > 0 needs dropout_seed= (an int32)")
        if bias is not None:
            if bias.ndim == 4:
                if bias.shape[0] != 1:
                    raise ValueError(
                        "flash_attention bias must be batch-shared: got "
                        f"leading dim {bias.shape[0]} (use the einsum path "
                        "for per-batch biases)")
                bias = bias[0]
            if tuple(bias.shape) != (H, T, T):
                raise ValueError(f"bias must be (H, T, T) = ({H}, {T}, {T}), "
                                 f"got {tuple(bias.shape)}")
            bias = bias.float()
        if kv_mask is not None and tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"kv_mask must be (B, T) = ({B}, {T}), "
                             f"got {tuple(kv_mask.shape)}")
        if sink is not None and tuple(sink.shape) != (H,):
            raise ValueError(f"sink must be ({H},), got {tuple(sink.shape)}")
        if q_start is not None:
            if not causal:
                raise ValueError("q_start (packed sequences) requires causal")
            if tuple(q_start.shape) != (B, T):
                raise ValueError(f"q_start must be (B, T) = ({B}, {T}), "
                                 f"got {tuple(q_start.shape)}")
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(hd)
        if q.device.type == "cpu":
            return reference_flash_attention(
                q, k, v, sm_scale, window, causal, dropout, dropout_seed,
                bias=bias, sink=sink, kv_mask=kv_mask, q_start=q_start)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                             f"got {q.device}")
        kvm = (None if kv_mask is None else torch.zeros(
            B, T, dtype=torch.float32, device=q.device).masked_fill_(
            ~kv_mask.bool(), _NEG_INF))
        qs = (None if q_start is None
              else q_start.to(device=q.device, dtype=torch.int32).contiguous())
        return _FlashAttention.apply(
            q, k, v, None if bias is None else bias.contiguous(), kvm, qs,
            None if sink is None else sink.float().contiguous(),
            float(sm_scale), bool(causal), int(window), float(dropout),
            _int32(dropout_seed or 0))
