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

The kernels split each step's product over the blocks of a thread-block
cluster by the contraction index; :func:`make_plan` lays a call out from
shapes, the card's SM count and its cluster occupancy, and the kernels read
that plan as it is.  :func:`split_lstm_reference_fwd` and
:func:`split_lstm_reference_bwd` are the same algorithm in plain PyTorch,
for the tests and the card's checks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neuralnetworklibrary_tpu_torch.kernels import build

_BF16 = torch.bfloat16

# Constants of csrc/lstm_scan.cu the plan depends on
THREADS = 512        # kThreads
WARPS = THREADS // 32
K_TILE = 64          # kKTile: k columns per ring tile
RING_PITCH = 72      # kRingPitch: elements per ring row
MAX_ROWS = 64        # kMaxRows: batch rows per chunk
MAX_N_TILES = 8      # kMaxNTiles: 8-column tiles one warp holds
CLUSTERS = (1, 2, 4, 8)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use (227 KB)
STAGES = 4           # ring depth
# default_cluster: the largest cluster up to MAX_CLUSTER whose k shares keep
# at least one ring tile (chip_smoke.py --tile-sweep: K6 at C 8 needs
# 32-row chunks at H 1150 and loses to C 4; K7 is fastest at C 8)
MAX_CLUSTER = {"fwd": 4, "bwd": 8}
MIN_SHARE = K_TILE
# the int[] the kernels read their layout from (enum PlanField)
PLAN_FIELDS = ("cluster", "units_per_block", "clusters", "ld", "k_share",
               "k_tiles", "k_pitch", "cols", "batch_chunk", "k_groups",
               "n_split", "stages", "off_ring", "off_part", "off_recv",
               "off_carry", "off_bar", "smem_bytes")
_KIND = {"fwd": 0, "bwd": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # xp, w, h0, c0, ys, cs, gates, hT, cT, scratch, counter, plan; T, B,
    # H; stream
    "nnl_lstm_fwd": ([_P] * 12 + [_I] * 3 + [_P], _I),
    # wT, gates, cs, cprev, dys, dhT, dcT, dgates, dh0, dc0, scratch,
    # counter, plan; T, B, H; stream
    "nnl_lstm_bwd": ([_P] * 13 + [_I] * 3 + [_P], _I),
    # kind, cluster, smem bytes, out
    "nnl_lstm_max_clusters": ([_I] * 3 + [_P], _I),
    # out, n: the stamps of the trace build
    "nnl_lstm_trace": ([_P, _P], _I),
    "nnl_lstm_error_string": ([_I], ctypes.c_char_p),
}
_run = functools.partial(build.check_call, "lstm_scan", SIGNATURES)
# grid-barrier counters by (device, stream): each launch leaves its
# counter's low bits at zero, and launches on one stream do not overlap
_COUNTERS = {}


def _cdiv(a, b):
    return -(-a // b)


def _round_up(a, b):
    return _cdiv(a, b) * b


def default_cluster(kind: str, H: int) -> int:
    """C for a call: the largest cluster up to MAX_CLUSTER[kind] whose k
    shares keep at least MIN_SHARE columns of the contraction (H for K6,
    4H for K7)."""
    kdim = H if kind == "fwd" else 4 * H
    return max(c for c in CLUSTERS if c == 1 or (
        c <= MAX_CLUSTER[kind] and kdim // c >= MIN_SHARE))


def _warp_split(m_tiles, n_tiles, k_steps):
    """(k_groups, n_split): how the warps share a chunk's product, the one
    that leaves the fewest mma steps to the busiest warp (then the fewest
    k-groups, whose partials take shared memory)."""
    best = None
    for kg in (1, 2, 4, 8, 16):
        if m_tiles * kg > WARPS:
            break
        ns = min(n_tiles, WARPS // (m_tiles * kg))
        per = _cdiv(n_tiles, ns)
        if per > MAX_N_TILES:
            continue
        key = (per * _cdiv(k_steps, kg), kg)
        if best is None or key < best[0]:
            best = (key, kg, ns)
    return None if best is None else best[1:]


def make_plan(kind: str, B: int, H: int, sm_count: int, cluster: int,
              max_clusters, smem_limit: int = SMEM_LIMIT,
              stages: int = STAGES) -> dict:
    """The layout of a K6 ('fwd') or K7 ('bwd') call, as the kernels read
    it (``PLAN_FIELDS``, plus ``blocks``).

    Clusters of ``cluster`` blocks; each block owns ``units_per_block``
    hidden units for the cell and multiplies its ``k_share`` columns of the
    contraction for all of its cluster's columns.  ``max_clusters`` is how
    many such clusters the card holds at once, an int or a function of the
    block's shared-memory bytes (the occupancy calculator's answer); the
    units per block start from an even spread over ``sm_count`` SMs and
    grow until the grid fits.  Raises ValueError where the weights, the
    ring and the partials do not fit in ``smem_limit`` bytes."""
    if kind not in _KIND or cluster not in CLUSTERS or B < 1 or H < 1 \
            or not 2 <= stages <= 8:
        raise ValueError(f"lstm_scan plan: kind {kind!r}, cluster "
                         f"{cluster}, B {B}, H {H}, stages {stages}")
    fwd = kind == "fwd"
    ld = _round_up(H if fwd else 4 * H, 8)
    k_share = _round_up(_cdiv(ld, cluster), 16)
    k_tiles = _cdiv(k_share, K_TILE)
    k_pitch = k_tiles * K_TILE + 8
    u = _cdiv(H, cluster * max(1, sm_count // cluster))
    while True:
        clusters = _cdiv(H, cluster * u)
        tiles = _cdiv((4 if fwd else 1) * cluster * u, 8)
        # batch rows per chunk: the most (up to MAX_ROWS, evened out over
        # the chunks) whose product the warps can hold
        for most in (MAX_ROWS, 32, 16):
            rows = _round_up(_cdiv(B, _cdiv(B, most)), 16)
            split = _warp_split(rows // 16, tiles, k_share // 16)
            if split:
                break
        if split is None:
            raise ValueError(f"lstm_scan: {kind} at H {H}, cluster "
                             f"{cluster}: {tiles} column tiles do not "
                             f"fit the warps of a block")
        kg, ns = split
        # every warp holds the same number of column tiles
        cols = 8 * ns * _cdiv(tiles, ns)
        # each block's partials, by the block that owns their columns
        # (4u gate columns in K6, u units in K7), and in a cluster the
        # partials of its own columns that every block sends it
        slices = cluster * kg * rows * (4 if fwd else 1) * u * 4
        off_ring = _round_up(cols * k_pitch * 2, 128)
        off_part = _round_up(off_ring + stages * rows * RING_PITCH * 2, 128)
        off_recv = _round_up(off_part + slices, 128)
        off_carry = _round_up(off_recv + (slices if cluster > 1 else 0), 128)
        off_bar = _round_up(off_carry + (1 if fwd else 2) * B * u * 4, 16)
        smem = off_bar + 16
        if smem > smem_limit:
            raise ValueError(
                f"lstm_scan: {kind} at B {B}, H {H}, cluster {cluster} "
                f"needs {smem} bytes of shared memory per block ({u} units "
                f"per block), over {smem_limit}")
        fit = max_clusters(smem) if callable(max_clusters) else max_clusters
        if clusters <= fit:
            break
        u += 1
    plan = dict(cluster=cluster, units_per_block=u, clusters=clusters, ld=ld,
                k_share=k_share, k_tiles=k_tiles, k_pitch=k_pitch, cols=cols,
                batch_chunk=rows, k_groups=kg, n_split=ns, stages=stages,
                off_ring=off_ring, off_part=off_part, off_recv=off_recv,
                off_carry=off_carry, off_bar=off_bar, smem_bytes=smem)
    plan["blocks"] = clusters * cluster
    return plan


@functools.cache
def _max_clusters(index: int, kind: str, cluster: int, smem: int) -> int:
    out = ctypes.c_int()
    with torch.cuda.device(index):
        _run("nnl_lstm_max_clusters", _KIND[kind], cluster, smem,
             ctypes.byref(out))
    return out.value


@functools.cache
def _plan_on(index: int, kind: str, B: int, H: int, cluster: int,
             stages: int) -> dict:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return make_plan(kind, B, H, sms, cluster,
                     lambda smem: _max_clusters(index, kind, cluster, smem),
                     stages=stages)


def kernel_plan(kind: str, B: int, H: int, cluster: int | None = None,
                stages: int = STAGES, device=None) -> dict:
    """How K6 ('fwd') or K7 ('bwd') lays a call out on the card: the
    :func:`make_plan` of the card's SMs and cluster occupancy, with
    ``cluster`` from :func:`default_cluster` unless given."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if cluster is None:
        cluster = default_cluster(kind, H)
    return _plan_on(index, kind, B, H, cluster, stages)


def _counter(device):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _plan_array(plan):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(plan[f] for f in PLAN_FIELDS))


# ------------------------------------------------------------ plain versions


def reference_lstm_fwd(xp_tm, w, h0, c0, product=torch.matmul):
    """The plain version of K6 (``_fwd_call``): time-major xp (T, B, 4H),
    w (H, 4H), h0/c0 (B, H) -> ys, cs (T, B, H) bf16, gates (T, B, 4H)
    bf16 (post-activation, [i, f, g, o]), hT, cT (B, H) float32.  xp and w
    are rounded to bf16; each step multiplies bf16(h) by them in float32
    (``product``)."""
    T = xp_tm.shape[0]
    xp = xp_tm.to(_BF16).float()
    w = w.to(_BF16).float()
    h, c = h0.float(), c0.float()
    ys, cs, gates = [], [], []
    for t in range(T):
        pre = xp[t] + product(h.to(_BF16).float(), w)
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(_BF16))
        cs.append(c.to(_BF16))
        gates.append(torch.cat([i, f, g, o], dim=-1).to(_BF16))
    return torch.stack(ys), torch.stack(cs), torch.stack(gates), h, c


def reference_lstm_bwd(wT, gates, cs, cprev, dys, dhT, dcT,
                       product=torch.matmul):
    """The plain version of K7 (``_bwd_call``): wT (4H, H), the bf16
    residuals gates (T, B, 4H), cs and cprev (T, B, H), float32 dys
    (T, B, H) and dhT, dcT (B, H) -> dgates (T, B, 4H), dh0, dc0 (B, H),
    all float32.  dgates is rounded to bf16 for the dh product
    (``product``)."""
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
        dh_carry = product(dgates.to(_BF16).float(), wT)
        dc = dc * f
    return torch.stack(out), dh_carry, dc


def split_product(plan):
    """The kernels' step product a @ w in plain PyTorch: one float32
    partial for each block of a cluster (its k share) and each k-group
    (the share's 16-column steps s with s % k_groups == kg), summed in the
    kernels' order: blocks in rank order, k-groups in order."""
    share, groups = plan["k_share"], plan["k_groups"]

    def product(a, w):
        k = torch.arange(w.shape[0], device=w.device)
        owner = k // share
        group = (k % share) // 16 % groups
        acc = torch.zeros(a.shape[0], w.shape[1], device=a.device)
        for c in range(plan["cluster"]):
            for kg in range(groups):
                idx = k[(owner == c) & (group == kg)]
                acc = acc + a[:, idx] @ w[idx]
        return acc

    return product


def split_lstm_reference_fwd(xp_tm, w, h0, c0, plan):
    """K6's algorithm in plain PyTorch (tests and chip_smoke.py only): the
    plain version with :func:`split_product` of ``plan``."""
    return reference_lstm_fwd(xp_tm, w, h0, c0, split_product(plan))


def split_lstm_reference_bwd(wT, gates, cs, cprev, dys, dhT, dcT, plan):
    """K7's algorithm in plain PyTorch, as :func:`split_lstm_reference_fwd`."""
    return reference_lstm_bwd(wT, gates, cs, cprev, dys, dhT, dcT,
                              split_product(plan))


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


def lstm_fwd(xp_tm, w, h0, c0, *, cluster=None, stages=STAGES):
    """K6 on contiguous CUDA tensors: xp_tm (T, B, 4H) bf16, w (H, 4H)
    bf16, h0/c0 (B, H) float32 -> the outputs of
    :func:`reference_lstm_fwd`, laid out by :func:`kernel_plan` (cluster
    and ring depth as given, for measurement).  ``lstm_fwd.launches``
    counts launches."""
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
    plan = kernel_plan("fwd", B, H, cluster, stages, dev)
    ys = torch.empty(T, B, H, dtype=_BF16, device=dev)
    cs = torch.empty_like(ys)
    gates = torch.empty_like(xp_tm)
    hT = torch.empty(B, H, dtype=f32, device=dev)
    cT = torch.empty_like(hT)
    scratch = torch.empty(2, B, plan["ld"], dtype=_BF16, device=dev)
    with torch.cuda.device(dev):
        _run("nnl_lstm_fwd", xp_tm.data_ptr(), w.data_ptr(),
             h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
             gates.data_ptr(), hT.data_ptr(), cT.data_ptr(),
             scratch.data_ptr(), _counter(dev).data_ptr(), _plan_array(plan),
             T, B, H, _stream(xp_tm))
    lstm_fwd.launches += 1
    return ys, cs, gates, hT, cT


def lstm_bwd(wT, gates, cs, cprev, dys, dhT, dcT, *, cluster=None,
             stages=STAGES):
    """K7 on contiguous CUDA tensors, with the inputs and outputs of
    :func:`reference_lstm_bwd` (wT and the residuals bf16, the rest
    float32); cluster and ring depth as :func:`lstm_fwd`.
    ``lstm_bwd.launches`` counts launches."""
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
    plan = kernel_plan("bwd", B, H, cluster, stages, dev)
    dgates = torch.empty(T, B, G, dtype=f32, device=dev)
    dh0 = torch.empty(B, H, dtype=f32, device=dev)
    dc0 = torch.empty_like(dh0)
    scratch = torch.empty(2, B, plan["ld"], dtype=_BF16, device=dev)
    with torch.cuda.device(dev):
        _run("nnl_lstm_bwd", wT.data_ptr(), gates.data_ptr(),
             cs.data_ptr(), cprev.data_ptr(), dys.data_ptr(),
             dhT.data_ptr(), dcT.data_ptr(), dgates.data_ptr(),
             dh0.data_ptr(), dc0.data_ptr(), scratch.data_ptr(),
             _counter(dev).data_ptr(), _plan_array(plan), T, B, H,
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
