"""Paged decode attention: one token per slot attends to its K/V rows in a
shared block pool, found through the slot's block table.

Counterpart of ``neuralnetworklibrary_tpu/ops/paged_attention.py``.  On a
CUDA tensor :func:`paged_attention` launches the hand-written Hopper kernel
in ``csrc/paged_attention.cu`` (or raises); on a CPU tensor it runs
:func:`reference_paged_attention`, the plain gather-then-matmul version of
the same function.  There is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@functools.cache
def _lib():
    from neuralnetworklibrary_tpu_torch.kernels.build import load

    lib = load("paged_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    # q, pools, scales, sink, table, offsets, out; B, H, Hkv, hd, N, bs,
    # MB; sm_scale; window, q dtype, kv dtype; stream
    lib.nnl_paged_attention.argtypes = [p] * 9 + [i] * 7 + [
        ctypes.c_float, i, i, i, p]
    lib.nnl_paged_attention.restype = i
    lib.nnl_paged_attention_smem_bytes.argtypes = [i, i]
    lib.nnl_paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.nnl_cuda_error_string.argtypes = [i]
    lib.nnl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, pool_k, pool_v, pool_k_scale, pool_v_scale):
    B, H, hd = q.shape
    N, bs, Hkv, hd_k = pool_k.shape
    if pool_v.shape != pool_k.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)} do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"H {H} must be a multiple of Hkv {Hkv}")
    if hd % 8 or hd > 256:
        raise ValueError(f"head dim {hd} must be a multiple of 8 and <= 256")
    if pool_k.dtype == torch.int8 and (pool_k_scale is None
                                       or pool_v_scale is None):
        raise ValueError("int8 pools need pool_k_scale/pool_v_scale")


def _offsets(offsets, B, device):
    off = torch.as_tensor(offsets, dtype=torch.int32, device=device)
    return off.expand(B).contiguous() if off.ndim == 0 else off


def paged_attention(q, pool_k, pool_v, block_table, offsets, *,
                    sm_scale=None, window: int = 0,
                    pool_k_scale=None, pool_v_scale=None, sink=None):
    """Single-step decode attention over a paged KV pool.

    q: (B, H, hd), float32 or bfloat16 — this step's queries.
    pool_k/pool_v: (N, bs, Hkv, hd) shared pools, float32, bfloat16, or int8
    with the (N, bs, Hkv) float32 scale pools given.  block_table: (B, MB)
    int32 pool rows per logical block.  offsets: (B,) int32 (or a scalar) —
    THIS token's position; its K/V must already be in the pool.  window > 0
    keeps (off - window, off].  sink: (H,) per-head logit joining only the
    normalizer.  Returns (B, H, hd) in q's dtype.

    ``paged_attention.launches`` counts kernel launches (CUDA tensors only).
    """
    _check_shapes(q, pool_k, pool_v, pool_k_scale, pool_v_scale)
    if q.device.type == "cpu":
        return reference_paged_attention(
            q, pool_k, pool_v, block_table, offsets, sm_scale=sm_scale,
            window=window, pool_k_scale=pool_k_scale,
            pool_v_scale=pool_v_scale, sink=sink)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    B, H, hd = q.shape
    N, bs, Hkv, _ = pool_k.shape
    MB = block_table.shape[1]
    quant = pool_k.dtype == torch.int8
    off = _offsets(offsets, B, q.device)
    if sink is not None:
        sink = sink.to(torch.float32).contiguous()
    named = {"q": q, "pool_k": pool_k, "pool_v": pool_v,
             "block_table": block_table, "offsets": off, "sink": sink}
    if quant:
        named.update(pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale)
    want = {"q": (torch.float32, torch.bfloat16),
            "pool_k": (torch.float32, torch.bfloat16, torch.int8),
            "pool_v": (pool_k.dtype,), "block_table": (torch.int32,),
            "offsets": (torch.int32,), "sink": (torch.float32,),
            "pool_k_scale": (torch.float32,),
            "pool_v_scale": (torch.float32,)}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in want[name]:
            raise ValueError(f"{name} dtype {t.dtype} not in {want[name]}")
    if block_table.shape[0] != B or off.shape != (B,):
        raise ValueError("block_table and offsets need one row per slot")
    if sink is not None and sink.shape != (H,):
        raise ValueError(f"sink must be ({H},), got {tuple(sink.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    if lib.nnl_paged_attention_smem_bytes(H // Hkv, hd) > 232448:
        raise ValueError(f"{H // Hkv} query heads per kv head at hd {hd} "
                         f"need more shared memory than a block has")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.nnl_paged_attention(
            ptr(q), ptr(pool_k), ptr(pool_v),
            ptr(pool_k_scale if quant else None),
            ptr(pool_v_scale if quant else None), ptr(sink),
            ptr(block_table), ptr(off), ptr(out),
            B, H, Hkv, hd, N, bs, MB, float(sm_scale), int(window),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype], stream)
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.nnl_cuda_error_string(err).decode())
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def reference_paged_attention(q, pool_k, pool_v, block_table, offsets, *,
                              sm_scale=None, window: int = 0,
                              pool_k_scale=None, pool_v_scale=None,
                              sink=None):
    """The plain version: gather each slot's strip, matmul, masked softmax
    (mirrors the JAX ``reference_paged_attention`` and the model's gather
    path).  Any device; computes in q's dtype."""
    B, H, hd = q.shape
    N, bs, Hkv, _ = pool_k.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    G = H // Hkv
    table = block_table.long()
    off = _offsets(offsets, B, q.device).long()
    Mp = table.shape[1] * bs
    kf = pool_k[table].reshape(B, Mp, Hkv, hd)
    vf = pool_v[table].reshape(B, Mp, Hkv, hd)
    if pool_k.dtype == torch.int8:
        kf = (kf.float() * pool_k_scale[table].reshape(B, Mp, Hkv, 1))
        vf = (vf.float() * pool_v_scale[table].reshape(B, Mp, Hkv, 1))
    kf = kf.to(q.dtype).repeat_interleave(G, dim=2)
    vf = vf.to(q.dtype).repeat_interleave(G, dim=2)
    att = torch.einsum("bhd,bkhd->bhk", q, kf) * sm_scale
    pos = torch.arange(Mp, device=q.device)[None, None, :]
    mask = pos <= off[:, None, None]
    if window > 0:
        mask &= pos > off[:, None, None] - window
    att = att.masked_fill(~mask, _NEG_INF)
    if sink is not None:
        sc = sink.to(att.dtype)[None, :, None].expand(B, H, 1)
        att = torch.softmax(torch.cat([att, sc], -1), dim=-1)[..., :-1]
    else:
        att = torch.softmax(att, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", att, vf).to(q.dtype)
