"""K3's query range on packed rows (``csrc/flash_attention.cu``
``flash_bwd_dkv_tc_kernel`` with ``dkv_doc_ends``): with ``q_start`` and
no dS scratch, each block of 128 keys (and each consumer's 64) visits the
query tiles from its own position up to the tile of the last query whose
document start, clamped to the query's position, is at or before its last
key, instead of every tile of the causal range.

On the CPU: that rule (:func:`tile_counts`, the host count the card's
counters are held to) never leaves out a tile that holds an attended
pair, on packed and on unsorted starts, and is tight on packed rows; the
wrappers hand the kernel the device tile counter only while tracing is
on, and ``tracing.counters()`` carries both counts.

On the card: bf16 dk and dv at hd 64 and hd 128 against
``reference_dkv_dbias`` (fed the kernels' own lse and delta) within the
flash kernels' bf16 tolerance, and bit for bit against the same kernel
over the whole causal range (the dbias call, whose dS scratch keeps the
whole range, with a zero bias), on every layout below; with a bias, dbias
against the reference's dS summed over the batch; and the two counters
against :func:`tile_counts`.  The card tests run where no JAX is
installed, so this file imports none:

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_port_flash_dkv_range.py
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu_torch.data.packing import pack_documents
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
from neuralnetworklibrary_tpu_torch.utils import tracing

ROWS = 128                          # keys of a K3 block (two consumers)
EOS, PAD = 0, 1
# the flash kernels' bf16 tolerance (chip_smoke.py FLASH_TOL, DBIAS_TOL):
# |got - want| <= atol + rtol |want|, dbias <= a max|want| + rtol |want|
ATOL, RTOL = 3e-2, 1e-2
DBIAS_A, DBIAS_RTOL = 1e-5, 1e-3


def query_tile(hd: int) -> int:
    """K3's query-tile width at head dim hd, as the source sets it."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    return int(re.search(rf"constexpr int kDkvQTile{hd} = (\d+);",
                         src).group(1))


def tile_counts(qs, bq: int, window: int = 0, rows: int = ROWS):
    """(visited, causal): the query tiles of width bq that K3's blocks of
    ``rows`` keys visit over the (B, T) document starts ``qs``, and those
    of the whole causal range (cut by ``window`` where > 0), summed over
    the blocks of one head."""
    qs = np.asarray(qs, np.int64)
    B, T = qs.shape
    clamped = np.minimum(qs, np.arange(T))
    visited = causal = 0
    for b in range(B):
        for kb0 in range(0, T, rows):
            i_begin, i_end = kb0 // bq, (T - 1) // bq
            if window > 0:
                i_end = min(i_end, (kb0 + rows - 1 + window - 1) // bq)
            seen = np.nonzero(clamped[b, kb0:] <= kb0 + rows - 1)[0]
            last = kb0 + int(seen.max())
            visited += min(i_end, last // bq) - i_begin + 1
            causal += i_end - i_begin + 1
    return visited, causal


def starts_of(lengths_per_row):
    """(B, T) int32 document starts of rows of the given document
    lengths."""
    return np.stack([np.repeat(np.cumsum([0] + ls[:-1]), ls)
                     for ls in lengths_per_row]).astype(np.int32)


def packed_starts(rng, B, T, median=672, sigma=1.0):
    """Document starts of B rows packed as the packed-web cell packs them:
    log-normal lengths (median 672, sigma 1.0, in [8, T - 1]), each
    document closed by the separator, first-fit-decreasing by
    ``pack_documents`` into about 4 B rows, of which B are drawn; the
    trailing pads are one segment; a segment starts
    right after each separator, as ``TransformerLM(reset_at=)`` sets
    it."""
    lengths, need = [], 4 * B * (T + 1)
    while sum(lengths) < need:
        lengths.append(int(np.clip(np.exp(np.log(median)
                                          + sigma * rng.normal()),
                                   8, T - 1)))
    docs = [np.full(n, 2, np.int32) for n in lengths]
    x, _, _ = pack_documents(docs, T, EOS, pad_token=PAD)
    x = x[rng.permutation(len(x))[:B]]
    sep = np.zeros(x.shape, bool)
    sep[:, 1:] = x[:, :-1] == EOS
    idx = np.arange(T)
    return np.maximum.accumulate(np.where(sep, idx, 0), axis=1).astype(
        np.int32)


def layout(name, rng, T):
    """(B, T) document starts of each layout the card tests run, and the
    causal window (0 for none)."""
    if name == "packed_web":
        return packed_starts(rng, 4, T), 0
    if name == "mid_tile":              # ends inside 32- and 64-row tiles
        return starts_of([[45, 300, 77, T - 422], [T // 2 + 13,
                                                   T // 2 - 13]]), 0
    if name == "block_edge":            # ends on 128-key block edges
        return starts_of([[128, 256, T - 384], [384, T - 384]]), 0
    if name == "one_token":
        return starts_of([[1, 127, 1, 1, 300, 1, T - 431],
                          [T - 1, 1]]), 0
    if name == "trailing_pad":          # the pads after the last separator
        return starts_of([[200, 333, 100, T - 633], [70, T - 70]]), 0
    if name == "whole_row":
        return np.zeros((2, T), np.int32), 0
    if name == "unsorted":              # starts that go back and jump
        qs = starts_of([[100, 200, T - 300], [T]])
        qs[0, 400:700] = 50
        qs[0, 800:900] = 700
        qs[1, 500:600] = rng.integers(0, 500, 100)
        qs[1, 10] = 10
        return qs, 0
    if name == "window":
        return starts_of([[300, 500, T - 800], [T]]), 160
    if name == "key_mask":
        return starts_of([[200, 400, T - 600], [90, T - 90]]), 0
    raise ValueError(name)


LAYOUTS = ("mid_tile", "block_edge", "one_token", "trailing_pad",
           "whole_row", "unsorted", "window", "key_mask")


# ------------------------------------------------------------------ CPU


def _pairs_of_tile(qs, b, kb0, bq, i, window, rows=ROWS):
    """Whether query tile i holds a pair that attends a key of the block
    at kb0 (by position, window and document start)."""
    T = qs.shape[1]
    q = np.arange(i * bq, min((i + 1) * bq, T))[:, None]
    k = np.arange(kb0, min(kb0 + rows, T))[None, :]
    ok = (k <= q) & (k >= qs[b, q])
    if window > 0:
        ok &= q - k < window
    return bool(ok.any())


@pytest.mark.parametrize("bq", [32, 64])
@pytest.mark.parametrize("name", ("packed_web",) + LAYOUTS)
def test_the_range_keeps_every_attended_tile(name, bq):
    """No query tile past a block's bounded end attends any of its keys,
    and on packed rows (starts that only rise) the bound is tight: the
    block's last visited tile holds an attended pair."""
    rng = np.random.default_rng(5)
    T = 1024
    qs, window = layout(name, rng, T)
    clamped = np.minimum(qs, np.arange(T))
    monotone = bool((np.diff(qs, axis=1) >= 0).all())
    for b in range(qs.shape[0]):
        for kb0 in range(0, T, ROWS):
            seen = np.nonzero(clamped[b, kb0:] <= kb0 + ROWS - 1)[0]
            end = (kb0 + int(seen.max())) // bq
            for i in range(end + 1, (T - 1) // bq + 1):
                assert not _pairs_of_tile(qs, b, kb0, bq, i, window)
            if monotone and window == 0:
                assert _pairs_of_tile(qs, b, kb0, bq, end, window)


def test_one_document_a_row_visits_the_whole_causal_range():
    qs = np.zeros((3, 777), np.int32)
    for bq in (32, 64):
        visited, causal = tile_counts(qs, bq)
        assert visited == causal > 0


def test_packed_rows_visit_the_tiles_of_their_pairs():
    """On packed rows the visited share of the causal tiles follows the
    share of causal pairs the documents attend, a few points above it for
    the tiles the documents' ends cut (the packed-web cell's own pools:
    53.1% of the tiles at 32-row tiles, 49.7% of the pairs)."""
    rng = np.random.default_rng(11)
    T = 4096
    qs = packed_starts(rng, 16, T)
    pairs = (np.arange(T)[None] - qs + 1).sum() / (16 * T * (T + 1) / 2)
    for bq in (32, 64):
        visited, causal = tile_counts(qs, bq)
        assert pairs < visited / causal < pairs + 0.08


@pytest.fixture
def fake_kernels(monkeypatch):
    """K3's wrapper on CPU tensors with a library that records the
    pointer each call hands it as ``tiles``."""
    seen = []

    def call(name, n_before):
        def f(*args):
            seen.append((name, args[n_before]))
            return 0
        return f

    lib = types.SimpleNamespace(**{n: (lambda *a: 0) for n in fa.SIGNATURES})
    lib.nnl_flash_bwd_dkv = call("dkv", 11)
    monkeypatch.setitem(build.BOUND, "flash_attention", lib)
    monkeypatch.setattr(fa, "_shape_args", lambda *a: ())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(fa, "_tiles", [None])
    tracing.disable()
    tracing.reset()
    yield seen
    tracing.disable()
    tracing.reset()


def _call_both():
    """K3's wrapper without and with document starts."""
    q = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(2, 8)
    args = (q, q, q, q, lse, lse, 0.125)
    fa.flash_bwd_dkv(*args)
    fa.flash_bwd_dkv(*args, qs=torch.zeros(1, 8, dtype=torch.int32))


def test_the_tile_counter_goes_to_the_kernel_only_while_tracing(
        fake_kernels):
    _call_both()
    assert fake_kernels and all(t is None for _, t in fake_kernels)
    assert fa.query_tiles() == (0, 0)
    fake_kernels.clear()
    tracing.enable()
    _call_both()
    ptrs = {t for _, t in fake_kernels}
    assert [n for n, _ in fake_kernels] == ["dkv", "dkv"]
    assert len(ptrs) == 1 and None not in ptrs
    assert ptrs == {fa._tiles[0].data_ptr()}
    assert fa._tiles[0].dtype == torch.int64
    assert tuple(fa._tiles[0].shape) == (2,)


def test_counters_carry_both_counts_as_copies(fake_kernels):
    counters = tracing.counters()
    assert counters["flash_bwd_dkv.query_tiles"] == 0
    assert counters["flash_bwd_dkv.causal_query_tiles"] == 0
    tracing.enable()
    _call_both()
    fa._tiles[0].copy_(torch.tensor([5, 9]))     # as the kernel adds
    counters = tracing.counters()
    fa._tiles[0].add_(100)                       # later launches
    assert int(counters["flash_bwd_dkv.query_tiles"]) == 5
    assert int(counters["flash_bwd_dkv.causal_query_tiles"]) == 9
    assert tracing.snapshot()["counters"]["flash_bwd_dkv.query_tiles"] == 105


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def _inputs(rng, B, T, H, hd, qs, window, key_mask=False, bias=False):
    """bf16 q, k, v, dO, then K1's lse and delta from them, on the card,
    with the kernels' keyword options."""
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q, k, v, do = (draw(B, T, H, hd).to("cuda", torch.bfloat16)
                   for _ in range(4))
    kw = {"qs": torch.from_numpy(qs).cuda()}
    if key_mask:
        m = torch.from_numpy(rng.random((B, T)) < 0.7)
        # each document's first key stays, so no row loses every key
        m[torch.arange(B)[:, None], kw["qs"].long().cpu()] = True
        kw["kvm"] = torch.zeros(B, T).masked_fill_(~m, -1e30).cuda()
    if bias:
        kw["bias"] = (draw(H, T, T) * 0.5).cuda()
    scale = hd ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, window, **kw)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    return (q, k, v, do, lse, delta, scale, window), kw


def _within(got, want, name):
    diff = (got.float() - want.float()).abs()
    room = ATOL + RTOL * want.float().abs()
    worst = float((diff / room).max())
    assert worst <= 1.0, f"{name}: {worst:.3g} of the tolerance"


def _whole_range(args, kw):
    """dk, dv of the same call over the whole causal range: the dbias
    call keeps it for its dS scratch (a zero bias adds nothing)."""
    H, T = args[0].shape[2], args[0].shape[1]
    zero = torch.zeros(H, T, T, device="cuda")
    return fa.flash_bwd_dkv_dbias(*args, **{**kw, "bias": zero})[:2]


def _check_dkv(args, kw):
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    wk, wv, _ = fa.reference_dkv_dbias(*args, **kw)
    fk, fv = _whole_range(args, kw)
    torch.cuda.synchronize()
    _within(dk, wk, "dk")
    _within(dv, wv, "dv")
    assert torch.equal(dk, fk) and torch.equal(dv, fv)


@pytest.mark.card
@pytest.mark.parametrize("hd", [64, 128])
def test_packed_web_rows_match_the_reference(card, hd):
    rng = np.random.default_rng(hd)
    qs, window = layout("packed_web", rng, 4096)
    _check_dkv(*_inputs(rng, 4, 4096, 2, hd, qs, window))


@pytest.mark.card
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", LAYOUTS)
def test_each_layout_matches_the_reference(card, name, hd):
    rng = np.random.default_rng(hd + len(name))
    qs, window = layout(name, rng, 1024)
    _check_dkv(*_inputs(rng, qs.shape[0], 1024, 3, hd, qs, window,
                        key_mask=name == "key_mask"))


@pytest.mark.card
@pytest.mark.parametrize("hd", [64, 128])
def test_a_bias_keeps_the_whole_range_for_dbias(card, hd):
    """With q_start and a bias's gradient, the dS scratch keeps every
    causal pair: dbias against the reference's dS summed over the batch,
    and dk, dv as the bounded call's, bit for bit."""
    rng = np.random.default_rng(3 * hd)
    qs, window = layout("mid_tile", rng, 1024)
    args, kw = _inputs(rng, 2, 1024, 2, hd, qs, window, bias=True)
    dk, dv, dbias = fa.flash_bwd_dkv_dbias(*args, **kw)
    bk, bv = fa.flash_bwd_dkv(*args, **kw)
    wk, wv, ds = fa.reference_dkv_dbias(*args, **kw)
    want = ds.sum(0)
    torch.cuda.synchronize()
    _within(dk, wk, "dk")
    _within(dv, wv, "dv")
    assert torch.equal(dk, bk) and torch.equal(dv, bv)
    room = DBIAS_A * float(want.abs().max()) + DBIAS_RTOL * want.abs()
    worst = float(((dbias - want).abs() / room).max())
    assert worst <= 1.0, f"dbias: {worst:.3g} of the tolerance"


@pytest.mark.card
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", ("packed_web", "whole_row", "unsorted",
                                  "window"))
def test_the_counters_equal_the_host_count(card, monkeypatch, name, hd):
    monkeypatch.setattr(fa, "_tiles", [None])
    rng = np.random.default_rng(7)
    T, H = (4096, 2) if name == "packed_web" else (1024, 3)
    qs, window = layout(name, rng, T)
    args, kw = _inputs(rng, qs.shape[0], T, H, hd, qs, window)
    tracing.enable()
    try:
        fa.flash_bwd_dkv(*args, **kw)
        visited, causal = fa.query_tiles()
        _whole_range(args, kw)
        v2, c2 = fa.query_tiles()
        torch.cuda.synchronize()
    finally:
        tracing.disable()
        tracing.reset()
    want_v, want_c = tile_counts(qs, query_tile(hd), window)
    assert (int(visited), int(causal)) == (H * want_v, H * want_c)
    # the dbias call visits the whole range, and counts it so
    assert (int(v2) - int(visited), int(c2) - int(causal)) == (
        H * want_c, H * want_c)
    if name == "whole_row":
        assert 100.0 * int(visited) / int(causal) == 100.0
