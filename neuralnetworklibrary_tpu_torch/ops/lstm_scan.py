"""LSTM scan over time, forward and backward, with bf16 weights resident.

Counterpart of ``neuralnetworklibrary_tpu/ops/pallas_lstm.py``.  On CUDA
tensors :func:`lstm_scan` is a ``torch.autograd.Function`` over two
hand-written Hopper kernels in ``csrc/lstm_scan.cu``: the forward scan
(:func:`lstm_fwd`, K6, replacing the Pallas ``_make_fwd_kernel``) and the
backward scan (:func:`lstm_bwd`, K7, replacing ``_make_bwd_kernel``), with
the weight gradient as one matrix product over T*B outside the kernel, as
the JAX custom VJP computes it (``_lstm_bwd_rule``).  On CPU tensors the
same Function runs :func:`reference_lstm_fwd` and
:func:`reference_lstm_bwd`, the plain PyTorch versions, so the CPU tests
reach the same layout, weight-gradient and unpadding code.  There is no
other fallback: a CUDA tensor launches the kernels or raises.

Numerics are the Pallas kernels', not the float32 scan's: xp and w_hh are
rounded to bf16 before the call; each step multiplies bf16(h) by the bf16
weights with float32 accumulation; the (h, c) carry stays float32; ys, cs
and the post-activation gates are stored in bf16, and ys comes back to the
caller bf16-rounded in xp's dtype.  The backward reads only those bf16
residuals (c_{t-1} = [c0, cs[:-1]], h_{t-1} = [h0, ys[:-1]]) and rounds
dgates to bf16 for the dh product.  No padding: the kernels mask the ragged
edge of H themselves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_BF16 = torch.bfloat16


@functools.cache
def _lib():
    from neuralnetworklibrary_tpu_torch.kernels.build import load

    lib = load("lstm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    # xp, w, h0, c0, ys, cs, gates, hT, cT; T, B, H; stream
    lib.nnl_lstm_fwd.argtypes = [p] * 9 + [i] * 3 + [p]
    # wT, gates, cs, cprev, dys, dhT, dcT, dgates, dh0, dc0, scratch;
    # T, B, H; stream
    lib.nnl_lstm_bwd.argtypes = [p] * 11 + [i] * 3 + [p]
    # kind, B, H, out (int[5])
    lib.nnl_lstm_plan.argtypes = [i, i, i, p]
    for fn in (lib.nnl_lstm_fwd, lib.nnl_lstm_bwd, lib.nnl_lstm_plan):
        fn.restype = i
    lib.nnl_lstm_error_string.argtypes = [i]
    lib.nnl_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _run(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError("lstm_scan kernel launch failed: "
                           + _lib().nnl_lstm_error_string(err).decode())


def kernel_plan(kind: str, B: int, H: int) -> dict:
    """How the kernels lay a call out on the current card: hidden units
    per block, blocks, batch rows staged per chunk, k-splits and dynamic
    shared memory.  ``kind`` is 'fwd' (K6) or 'bwd' (K7)."""
    out = (ctypes.c_int * 5)()
    _run(_lib().nnl_lstm_plan, {"fwd": 0, "bwd": 1}[kind], B, H, out)
    return dict(zip(("units_per_block", "blocks", "batch_chunk", "splits",
                     "smem_bytes"), out))


# ------------------------------------------------------------ plain versions


def reference_lstm_fwd(xp_tm, w, h0, c0):
    """The plain version of K6 (``_fwd_call``): time-major xp (T, B, 4H),
    w (H, 4H), h0/c0 (B, H) -> ys, cs (T, B, H) bf16, gates (T, B, 4H)
    bf16 (post-activation, [i, f, g, o]), hT, cT (B, H) float32.  xp and w
    are rounded to bf16; each step multiplies bf16(h) by them in float32."""
    T = xp_tm.shape[0]
    xp = xp_tm.to(_BF16).float()
    w = w.to(_BF16).float()
    h, c = h0.float(), c0.float()
    ys, cs, gates = [], [], []
    for t in range(T):
        pre = xp[t] + h.to(_BF16).float() @ w
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(_BF16))
        cs.append(c.to(_BF16))
        gates.append(torch.cat([i, f, g, o], dim=-1).to(_BF16))
    return torch.stack(ys), torch.stack(cs), torch.stack(gates), h, c


def reference_lstm_bwd(wT, gates, cs, cprev, dys, dhT, dcT):
    """The plain version of K7 (``_bwd_call``): wT (4H, H), the bf16
    residuals gates (T, B, 4H), cs and cprev (T, B, H), float32 dys
    (T, B, H) and dhT, dcT (B, H) -> dgates (T, B, 4H), dh0, dc0 (B, H),
    all float32.  dgates is rounded to bf16 for the dh product."""
    T = gates.shape[0]
    wT = wT.to(_BF16).float()
    dh_carry, dc = dhT.float(), dcT.float()
    out = [None] * T
    for t in reversed(range(T)):
        i, f, g, o = gates[t].float().chunk(4, dim=-1)
        tanh_c = torch.tanh(cs[t].float())
        dh = dys[t].float() + dh_carry
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        di, dg, df = dc * g, dc * i, dc * cprev[t].float()
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        out[t] = dgates
        dh_carry = dgates.to(_BF16).float() @ wT
        dc = dc * f
    return torch.stack(out), dh_carry, dc


# ------------------------------------------------------------ kernels


def _check(named: dict, want: dict, device):
    if device.type != "cuda":
        raise ValueError(f"the lstm_scan kernels take CUDA tensors, got "
                         f"{device}; the plain versions are "
                         f"reference_lstm_fwd and reference_lstm_bwd")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != want[name]:
            raise ValueError(f"{name} dtype {t.dtype} != {want[name]}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_fwd(xp_tm, w, h0, c0):
    """K6 on contiguous CUDA tensors: xp_tm (T, B, 4H) bf16, w (H, 4H)
    bf16, h0/c0 (B, H) float32 -> the outputs of
    :func:`reference_lstm_fwd`.  ``lstm_fwd.launches`` counts launches."""
    T, B, G = xp_tm.shape
    H = G // 4
    if G != 4 * H or T < 1 or B < 1 or tuple(w.shape) != (H, G) \
            or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"lstm_fwd: xp {tuple(xp_tm.shape)}, w "
                         f"{tuple(w.shape)}, h0 {tuple(h0.shape)}, c0 "
                         f"{tuple(c0.shape)} do not fit (T, B, 4H), (H, 4H), "
                         f"(B, H)")
    f32 = torch.float32
    _check({"xp": xp_tm, "w": w, "h0": h0, "c0": c0},
           {"xp": _BF16, "w": _BF16, "h0": f32, "c0": f32}, xp_tm.device)
    dev = xp_tm.device
    ys = torch.empty(T, B, H, dtype=_BF16, device=dev)
    cs = torch.empty_like(ys)
    gates = torch.empty_like(xp_tm)
    hT = torch.empty(B, H, dtype=f32, device=dev)
    cT = torch.empty_like(hT)
    with torch.cuda.device(dev):
        _run(_lib().nnl_lstm_fwd, xp_tm.data_ptr(), w.data_ptr(),
             h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
             gates.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, B, H,
             _stream(xp_tm))
    lstm_fwd.launches += 1
    return ys, cs, gates, hT, cT


def lstm_bwd(wT, gates, cs, cprev, dys, dhT, dcT):
    """K7 on contiguous CUDA tensors, with the inputs and outputs of
    :func:`reference_lstm_bwd` (wT and the residuals bf16, the rest
    float32).  ``lstm_bwd.launches`` counts launches."""
    T, B, G = gates.shape
    H = G // 4
    shapes = {"wT": (G, H), "cs": (T, B, H), "cprev": (T, B, H),
              "dys": (T, B, H), "dhT": (B, H), "dcT": (B, H)}
    named = {"wT": wT, "gates": gates, "cs": cs, "cprev": cprev, "dys": dys,
             "dhT": dhT, "dcT": dcT}
    bad = {n: tuple(named[n].shape) for n, s in shapes.items()
           if tuple(named[n].shape) != s}
    if G != 4 * H or T < 1 or B < 1 or bad:
        raise ValueError(f"lstm_bwd: shapes {bad} do not fit gates "
                         f"{tuple(gates.shape)}")
    f32 = torch.float32
    _check(named, {"wT": _BF16, "gates": _BF16, "cs": _BF16,
                   "cprev": _BF16, "dys": f32, "dhT": f32, "dcT": f32},
           gates.device)
    dev = gates.device
    dgates = torch.empty(T, B, G, dtype=f32, device=dev)
    dh0 = torch.empty(B, H, dtype=f32, device=dev)
    dc0 = torch.empty_like(dh0)
    scratch = torch.empty(2, B, G, dtype=_BF16, device=dev)
    with torch.cuda.device(dev):
        _run(_lib().nnl_lstm_bwd, wT.data_ptr(), gates.data_ptr(),
             cs.data_ptr(), cprev.data_ptr(), dys.data_ptr(),
             dhT.data_ptr(), dcT.data_ptr(), dgates.data_ptr(),
             dh0.data_ptr(), dc0.data_ptr(), scratch.data_ptr(), T, B, H,
             _stream(gates))
    lstm_bwd.launches += 1
    return dgates, dh0, dc0


lstm_fwd.launches = 0
lstm_bwd.launches = 0


def _pick(device, kernel, plain):
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"lstm_scan runs on cuda or cpu tensors, got {device}")


class _LSTMScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xp, w_hh, h0, c0):
        dev = xp.device
        with torch.autocast(dev.type, enabled=False):
            xp_tm = xp.transpose(0, 1).to(_BF16).contiguous()
            w = w_hh.to(_BF16).contiguous()
            h0f = h0.float().contiguous()
            c0f = c0.float().contiguous()
            ys, cs, gates, hT, cT = _pick(dev, lstm_fwd, reference_lstm_fwd)(
                xp_tm, w, h0f, c0f)
        ctx.save_for_backward(gates, cs, h0f, c0f, w, ys)
        ctx.dtypes = (xp.dtype, w_hh.dtype, h0.dtype, c0.dtype)
        return (ys.transpose(0, 1).to(xp.dtype), hT.to(xp.dtype),
                cT.to(xp.dtype))

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        gates, cs, h0f, c0f, w, ys = ctx.saved_tensors
        dev = gates.device
        with torch.autocast(dev.type, enabled=False):
            dys_tm = dys.transpose(0, 1).float().contiguous()
            cprev = torch.cat([c0f.to(_BF16)[None], cs[:-1]]).contiguous()
            dgates, dh0, dc0 = _pick(dev, lstm_bwd, reference_lstm_bwd)(
                w.t().contiguous(), gates, cs, cprev, dys_tm,
                dhT.float().contiguous(), dcT.float().contiguous())
            # the weight gradient as one product over T*B (_lstm_bwd_rule)
            T, B, G = dgates.shape
            hprev = torch.cat([h0f.to(_BF16)[None], ys[:-1]])
            dw = hprev.reshape(T * B, -1).float().t() @ dgates.reshape(T * B,
                                                                        G)
        xp_dt, w_dt, h_dt, c_dt = ctx.dtypes
        return (dgates.transpose(0, 1).to(xp_dt), dw.to(w_dt), dh0.to(h_dt),
                dc0.to(c_dt))


def lstm_scan(xp, w_hh, h0, c0):
    """LSTM over time with bf16 weights resident: xp (B, T, 4H) input
    projections plus biases, gate order [i, f, g, o]; w_hh (H, 4H); h0/c0
    (B, H).  Returns (ys (B, T, H), hT (B, H), cT (B, H)) in xp's dtype;
    differentiable in all four inputs.  The contract of the JAX
    ``lstm_scan`` (pallas_lstm.py:232), batch-major."""
    B, T, G = xp.shape
    H = G // 4
    if G != 4 * H or tuple(w_hh.shape) != (H, G) \
            or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"lstm_scan: xp {tuple(xp.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}, h0 {tuple(h0.shape)}, c0 "
                         f"{tuple(c0.shape)} do not fit (B, T, 4H), (H, 4H),"
                         f" (B, H)")
    return _LSTMScan.apply(xp, w_hh, h0, c0)
