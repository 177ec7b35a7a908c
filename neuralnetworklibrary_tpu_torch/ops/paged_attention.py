"""Paged decode attention: one token per slot attends to its K/V rows in a
shared block pool, found through the slot's block table.

Counterpart of ``neuralnetworklibrary_tpu/ops/paged_attention.py``.  On a
CUDA tensor :func:`paged_attention` launches the hand-written Hopper kernel
in ``csrc/paged_attention.cu`` (or raises); on a CPU tensor it runs
:func:`reference_paged_attention`, the plain gather-then-matmul version of
the same function.  There is no other fallback.

The kernel splits each slot's live range into S shares of ``CHUNK``-position
chunks, computes a partial online softmax per share and merges the shares in
order (flash-decoding).  :func:`num_splits` chooses S on the host from
shapes and the card's occupancy alone;
:func:`split_paged_attention_reference` is that algorithm in plain PyTorch,
for the tests and the card's checks.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from neuralnetworklibrary_tpu_torch.kernels import build

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# positions per staging chunk (kChunk in csrc/paged_attention.cu): the
# shares of a live range are cut at its multiples
CHUNK = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # q, pools, scales, sink, table, offsets, out, part_acc, part_ml,
    # tickets; B, H, Hkv, hd, N, bs, MB; sm_scale; window, splits, q dtype,
    # kv dtype; stream
    "nnl_paged_attention": ([_P] * 12 + [_I] * 7 + [ctypes.c_float]
                            + [_I] * 4 + [_P], _I),
    # B, H, Hkv
    "nnl_paged_attention_tickets": ([_I] * 3, _I),
    # H, Hkv, hd, q dtype, kv dtype
    "nnl_paged_attention_blocks_per_sm": ([_I] * 5, _I),
    "nnl_cuda_error_string": ([_I], ctypes.c_char_p),
}
# int32 tickets of the split merge, by (device, stream): each launch leaves
# them at zero, and launches on one stream do not overlap
_TICKETS = {}


def _tickets(device, stream, B, H, Hkv):
    lib = build.bind("paged_attention", SIGNATURES)
    n = lib.nnl_paged_attention_tickets(B, H, Hkv)
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                          device=device)
    return buf


@functools.cache
def _card(index: int, H: int, Hkv: int, hd: int, q_dtype, kv_dtype):
    """(SMs, blocks of the kernel one SM holds) on card ``index``."""
    with torch.cuda.device(index):
        lib = build.bind("paged_attention", SIGNATURES)
        per_sm = lib.nnl_paged_attention_blocks_per_sm(
            H, Hkv, hd, _DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype])
    if per_sm <= 0:
        raise RuntimeError(f"paged_attention: no occupancy for H {H}, Hkv "
                           f"{Hkv}, hd {hd}, {q_dtype}, {kv_dtype}")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            per_sm)


def splits_for(q, pool_k, block_table) -> int:
    """The S :func:`paged_attention` launches with for these CUDA tensors:
    :func:`num_splits` of the kernel's blocks per share (the tickets the
    library counts), the table's positions, the card's SMs and the kernel's
    occupancy (both cached per card and shape)."""
    B, H, hd = q.shape
    _, bs, Hkv, _ = pool_k.shape
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    sms, per_sm = _card(index, H, Hkv, hd, q.dtype, pool_k.dtype)
    lib = build.bind("paged_attention", SIGNATURES)
    units = lib.nnl_paged_attention_tickets(B, H, Hkv)
    return num_splits(units, block_table.shape[1] * bs, sms, per_sm)


def num_splits(units: int, positions: int, sm_count: int,
               blocks_per_sm: int) -> int:
    """S, the shares each slot's live range is cut into: as many as one
    wave of blocks holds (``sm_count`` x ``blocks_per_sm`` blocks over the
    ``units`` blocks one share takes), and no share shorter than two chunks
    of ``positions`` (the table's MB * bs).  It reads shapes only, never
    the offsets, which live on the card: the wrapper does not
    synchronise."""
    wave = sm_count * blocks_per_sm // max(units, 1)
    return max(1, min(wave, positions // (2 * CHUNK)))


def _check_shapes(q, pool_k, pool_v, pool_k_scale, pool_v_scale):
    """What the function needs on every device."""
    B, H, hd = q.shape
    N, bs, Hkv, hd_k = pool_k.shape
    if pool_v.shape != pool_k.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)} do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"H {H} must be a multiple of Hkv {Hkv}")
    if pool_k.dtype == torch.int8 and (pool_k_scale is None
                                       or pool_v_scale is None):
        raise ValueError("int8 pools need pool_k_scale/pool_v_scale")


def _check_kernel_shapes(q):
    """What the CUDA kernel takes beyond that."""
    hd = q.shape[-1]
    if hd % 8 or hd > 256:
        raise ValueError(f"head dim {hd} must be a multiple of 8 and <= 256 "
                         f"for the CUDA kernel")


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

    ``paged_attention.launches`` counts kernel launches (CUDA tensors
    only; one per call).
    """
    if q.device.type == "cpu":
        _check_shapes(q, pool_k, pool_v, pool_k_scale, pool_v_scale)
        return reference_paged_attention(
            q, pool_k, pool_v, block_table, offsets, sm_scale=sm_scale,
            window=window, pool_k_scale=pool_k_scale,
            pool_v_scale=pool_v_scale, sink=sink)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, pool_k, pool_v, block_table, offsets, sm_scale=sm_scale,
                   window=window, pool_k_scale=pool_k_scale,
                   pool_v_scale=pool_v_scale, sink=sink)


paged_attention.launches = 0


def _launch(q, pool_k, pool_v, block_table, offsets, *, splits=None,
            sm_scale=None, window=0, pool_k_scale=None, pool_v_scale=None,
            sink=None):
    """Check the arguments and launch the kernel on the current stream with
    S = ``splits`` (default :func:`splits_for`'s; chip_smoke.py sweeps
    it)."""
    _check_shapes(q, pool_k, pool_v, pool_k_scale, pool_v_scale)
    _check_kernel_shapes(q)
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
    for name in ("pool_k", "pool_v"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel stages rows in 16-byte pieces)")
    if block_table.shape[0] != B or off.shape != (B,):
        raise ValueError("block_table and offsets need one row per slot")
    if sink is not None and sink.shape != (H,):
        raise ValueError(f"sink must be ({H},), got {tuple(sink.shape)}")
    if splits is None:
        splits = splits_for(q, pool_k, block_table)
    if int(splits) < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = tickets = None
    if splits > 1:
        part_acc = torch.empty((B, H, splits, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                              device=q.device)
        tickets = _tickets(q.device, stream, B, H, Hkv)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.check_call(
        "paged_attention", SIGNATURES, "nnl_paged_attention",
        ptr(q), ptr(pool_k), ptr(pool_v), ptr(pool_k_scale if quant else None),
        ptr(pool_v_scale if quant else None), ptr(sink),
        ptr(block_table), ptr(off), ptr(out), ptr(part_acc), ptr(part_ml),
        ptr(tickets), B, H, Hkv, hd, N, bs, MB, float(sm_scale),
        int(window), int(splits), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[pool_k.dtype], stream)
    paged_attention.launches += 1
    return out


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


def split_paged_attention_reference(q, pool_k, pool_v, block_table, offsets,
                                    *, sm_scale=None, window: int = 0,
                                    pool_k_scale=None, pool_v_scale=None,
                                    sink=None, splits: int = 1):
    """The kernel's algorithm in plain PyTorch, in float32: clamp the table
    and offsets, cut each slot's live range [start, off] into ``splits``
    shares of whole ``CHUNK``-position chunks (chunks at multiples of
    CHUNK), take each share's (m, l, acc) — the int8 k-scales on the
    scores, the v-scales on p, l summing the unscaled p — and merge the
    shares in order, with the sink applied once at the merge.  An empty
    share is (-1e30, 0, 0).  Returns (B, H, hd) in q's dtype.  Used by the
    tests and chip_smoke.py, never on the main path."""
    B, H, hd = q.shape
    N, bs, Hkv, _ = pool_k.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    G = H // Hkv
    S = int(splits)
    dev = q.device
    table = block_table.long().clamp(0, N - 1)
    Mp = table.shape[1] * bs
    off = _offsets(offsets, B, dev).long().clamp(0, Mp - 1)
    start = (off - window + 1).clamp(min=0) if window > 0 else off * 0
    kf = pool_k[table].reshape(B, Mp, Hkv, hd).float()
    vf = pool_v[table].reshape(B, Mp, Hkv, hd).float()
    qf = q.float().reshape(B, Hkv, G, hd) * sm_scale
    s = torch.einsum("bkgd,bpkd->bkgp", qf, kf)            # (B, Hkv, G, Mp)
    vscale = torch.ones(B, Hkv, 1, Mp, device=dev)
    if pool_k.dtype == torch.int8:
        s = s * pool_k_scale[table].reshape(B, Mp, Hkv).permute(
            0, 2, 1)[:, :, None]
        vscale = pool_v_scale[table].reshape(B, Mp, Hkv).permute(
            0, 2, 1)[:, :, None]
    pos = torch.arange(Mp, device=dev)
    cf = start // CHUNK
    n = off // CHUNK - cf + 1
    sh = torch.arange(S + 1, device=dev)
    bounds = (cf[:, None] + sh[None] * n[:, None] // S) * CHUNK  # (B, S+1)
    live = (pos[None] >= start[:, None]) & (pos[None] <= off[:, None])
    share = (live[:, None] & (pos[None, None] >= bounds[:, :-1, None])
             & (pos[None, None] < bounds[:, 1:, None]))     # (B, S, Mp)
    keep = share[:, None, None]                             # (B,1,1,S,Mp)
    ss = torch.where(keep, s[:, :, :, None], _NEG_INF)      # (B,Hkv,G,S,Mp)
    m = ss.amax(-1)                                         # (B,Hkv,G,S)
    p = torch.where(keep, torch.exp(ss - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgsp,bpkd->bkgsd", p * vscale[:, :, :, None], vf)
    M = m.amax(-1)
    L = torch.zeros_like(M)
    A = torch.zeros_like(acc[..., 0, :])
    for i in range(S):                                      # in split order
        w = torch.exp(m[..., i] - M)
        L = L + l[..., i] * w
        A = A + acc[..., i, :] * w[..., None]
    if sink is not None:
        sk = sink.float().reshape(Hkv, G)[None]
        mt = torch.maximum(M, sk)
        sc = torch.exp(M - mt)
        L = L * sc + torch.exp(sk - mt)
        A = A * sc[..., None]
    out = A / L.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)
