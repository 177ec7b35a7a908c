"""The cluster split of the CUDA LSTM kernels (K6, K7) in plain PyTorch,
and the host plan that lays a call out.

``split_lstm_reference_fwd`` and ``split_lstm_reference_bwd`` compute each
step's product as the kernels do: one float32 partial per block of a
cluster (its k share) and per k-group, summed in the kernels' order, with
bf16 rounding at the kernels' places.  They are held against the JAX Pallas
kernels (``_fwd_call``, ``_bwd_call``, ``lstm_scan``) in interpret mode,
with JAX's dots in float32 (``default_matmul_precision("highest")``), at
the tolerances of tests/test_torch_port_lstm_scan.py: bf16 outputs within
one bf16 ulp at magnitude 1 (4e-3, a value that rounds the other way under
another order of the float32 sums), float32 outputs within 1e-4.  Plans
come from ``make_plan`` with small SM counts, so that the last cluster
owns fewer units than the others.  w_hh is drawn at the usual LSTM scale,
1/sqrt(H) (0.2 at H 24, as in that file): a bf16 value of h that rounds the
other way moves the next step's pre-activations by about |w| times its ulp,
and at H 130 with w of scale 0.2 the float32 carry drifts past 1e-4 from
such flips alone, in the plain version as in the split one.  For the same
reason B 65 is taken at H 25 and H 130 at B 3: at B 65, H 130 about one
dh0 in 600 moves by up to 2e-4 through flips of bf16(dgates) (the card's
checks in chip_smoke.py cover those shapes, with their own tolerance).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops import pallas_lstm as jax_lstm
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.ops import lstm_scan as ls

BF16_TOL = 4e-3
F32_TOL = 1e-4
# (B, T, H, SMs): B 1, 3, 65 (over one 64-row chunk), H 24, 25, 130
SHAPES = [(1, 5, 24, 8), (3, 6, 25, 8), (65, 4, 25, 8), (3, 7, 130, 16)]


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (T, B, 4 * H)).astype(np.float32),
            rng.normal(0, H ** -0.5, (H, 4 * H)).astype(np.float32),
            rng.normal(0, 0.3, (B, H)).astype(np.float32),
            rng.normal(0, 0.3, (B, H)).astype(np.float32),
            rng.normal(0, 1, (T, B, H)).astype(np.float32),
            rng.normal(0, 1, (B, H)).astype(np.float32),
            rng.normal(0, 1, (B, H)).astype(np.float32))


def _plan(kind, B, H, sms, cluster):
    return ls.make_plan(kind, B, H, sms, cluster, max(1, sms // cluster))


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@functools.cache
def _jax_fwd(B, T, H):
    xp, w, h0, c0 = _case(B, T, H, seed=B + H)[:4]
    with jax.default_matmul_precision("highest"):
        out = jax_lstm._fwd_call(jnp.asarray(xp, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16),
                                 jnp.asarray(h0), jnp.asarray(c0),
                                 interpret=True)
    return [np.asarray(a.astype(jnp.float32)) for a in out]


def _residuals(B, T, H):
    """K7's inputs: the bf16 residuals of the plain forward and the
    upstream gradients."""
    xp, w, h0, c0, dys, dhT, dcT = (torch.from_numpy(a)
                                    for a in _case(B, T, H, seed=B + H))
    _, cs, gates, _, _ = ls.reference_lstm_fwd(xp, w, h0, c0)
    cprev = torch.cat([c0.to(torch.bfloat16)[None], cs[:-1]])
    wT = w.to(torch.bfloat16).t().contiguous()
    return wT, gates, cs, cprev, dys, dhT, dcT


@functools.cache
def _jax_bwd(B, T, H):
    res = _residuals(B, T, H)
    with jax.default_matmul_precision("highest"):
        out = jax_lstm._bwd_call(*(_j(t) for t in res), interpret=True)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("B,T,H,sms", SHAPES)
def test_split_forward_matches_fwd_call(B, T, H, sms, cluster):
    plan = _plan("fwd", B, H, sms, cluster)
    # H 24 fills its clusters; at H 25 and 130 the last one is partial
    full = plan["clusters"] * cluster * plan["units_per_block"] == H
    assert full == (H == 24)
    xp, w, h0, c0 = (torch.from_numpy(a)
                     for a in _case(B, T, H, seed=B + H)[:4])
    got = ls.split_lstm_reference_fwd(xp, w, h0, c0, plan)
    for g, want, name in zip(got, _jax_fwd(B, T, H),
                             ("ys", "cs", "gates", "hT", "cT")):
        tol = BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("B,T,H,sms", SHAPES)
def test_split_backward_matches_bwd_call(B, T, H, sms, cluster):
    plan = _plan("bwd", B, H, sms, cluster)
    got = ls.split_lstm_reference_bwd(*_residuals(B, T, H), plan)
    for g, want, name in zip(got, _jax_bwd(B, T, H),
                             ("dgates", "dh0", "dc0")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_split_scan_matches_lstm_scan(cluster):
    """ys, hT, cT of the split forward against the JAX custom-VJP
    ``lstm_scan`` (batch-major) on the same inputs."""
    B, T, H, sms = 3, 6, 25, 8
    xp, w, h0, c0 = _case(B, T, H, seed=B + H)[:4]
    with jax.default_matmul_precision("highest"):
        want = jax_lstm.lstm_scan(jnp.asarray(np.swapaxes(xp, 0, 1)),
                                  jnp.asarray(w), jnp.asarray(h0),
                                  jnp.asarray(c0), True)
    ys, _, _, hT, cT = ls.split_lstm_reference_fwd(
        *(torch.from_numpy(a) for a in (xp, w, h0, c0)),
        _plan("fwd", B, H, sms, cluster))
    for g, wv, tol, name in ((ys.transpose(0, 1), want[0], BF16_TOL, "ys"),
                             (hT, want[1], F32_TOL, "hT"),
                             (cT, want[2], F32_TOL, "cT")):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(wv),
                                   rtol=0, atol=tol, err_msg=name)


def test_one_share_and_one_group_is_the_plain_product():
    """With C 1 and one k-group the split product is the plain one, bit for
    bit: a single partial, added to zero."""
    B, T, H = 3, 4, 24
    plan = {**ls.make_plan("fwd", B, H, 132, 1, 132), "k_groups": 1}
    assert plan["cluster"] == 1
    args = [torch.from_numpy(a) for a in _case(B, T, H, seed=1)[:4]]
    for g, w in zip(ls.split_lstm_reference_fwd(*args, plan),
                    ls.reference_lstm_fwd(*args)):
        assert torch.equal(g, w)


# ------------------------------------------------------------ the plan

PLAN_CASES = [  # kind, B, H, SMs, cluster, clusters the card holds
    ("fwd", 64, 1150, 132, 4, 30), ("bwd", 64, 1150, 132, 8, 15),
    ("fwd", 64, 400, 132, 4, 30), ("bwd", 64, 400, 132, 8, 15),
    ("fwd", 1100, 24, 132, 1, 132), ("bwd", 128, 1150, 132, 8, 15),
    ("fwd", 1, 1150, 132, 8, 15), ("bwd", 3, 25, 8, 2, 4),
    ("fwd", 65, 130, 16, 4, 4), ("bwd", 127, 130, 16, 1, 16)]


@pytest.mark.parametrize("kind,B,H,sms,cluster,cap", PLAN_CASES)
def test_plan_covers_every_unit_and_k_column_once(kind, B, H, sms, cluster,
                                                   cap):
    p = ls.make_plan(kind, B, H, sms, cluster, cap)
    C, u = p["cluster"], p["units_per_block"]
    assert p["blocks"] == p["clusters"] * C <= cap * C
    # block b owns units [b u, b u + u) of H, cut at H
    owner = np.zeros(H, int)
    for b in range(p["blocks"]):
        owner[b * u:min(H, b * u + u)] += 1
    assert (owner == 1).all()
    # rank c of a cluster multiplies k in [c share, (c + 1) share) of the
    # contraction (H for K6, 4H for K7; ld pads it to a multiple of 8)
    kdim = H if kind == "fwd" else 4 * H
    assert p["ld"] % 8 == 0 and kdim <= p["ld"] < kdim + 8
    cover = np.zeros(kdim, int)
    for c in range(C):
        cover[c * p["k_share"]:min(kdim, (c + 1) * p["k_share"])] += 1
    assert (cover == 1).all()
    assert p["k_share"] % 16 == 0
    assert p["k_tiles"] * ls.K_TILE >= p["k_share"] > (p["k_tiles"] - 1) \
        * ls.K_TILE
    # every block of a cluster computes all its columns; each warp holds the
    # same number of column tiles
    per_block = 4 * u if kind == "fwd" else u
    assert p["cols"] >= C * per_block and p["cols"] % (8 * p["n_split"]) == 0
    assert p["cols"] // 8 // p["n_split"] <= ls.MAX_N_TILES
    rows, kg = p["batch_chunk"], p["k_groups"]
    assert rows % 16 == 0 and 16 <= rows <= ls.MAX_ROWS
    assert (rows // 16) * kg * p["n_split"] <= ls.WARPS
    assert kg & (kg - 1) == 0
    assert -(-B // rows) * rows >= B > (-(-B // rows) - 1) * rows
    # shared memory: weights | ring | partials | received | carry | mbarrier
    assert p["off_ring"] >= p["cols"] * p["k_pitch"] * 2
    assert p["off_part"] >= p["off_ring"] + p["stages"] * rows \
        * ls.RING_PITCH * 2
    slices = C * kg * rows * per_block * 4
    assert p["off_recv"] >= p["off_part"] + slices
    assert p["off_carry"] >= p["off_recv"] + (slices if C > 1 else 0)
    assert p["off_bar"] >= p["off_carry"] + (1 if kind == "fwd" else 2) \
        * B * u * 4
    assert p["smem_bytes"] == p["off_bar"] + 16 <= ls.SMEM_LIMIT
    for f in ("off_ring", "off_part", "off_recv"):
        assert p[f] % 128 == 0, f
    assert p["off_carry"] % 16 == 0 and p["off_bar"] % 16 == 0
    assert set(ls.PLAN_FIELDS) <= set(p)


def test_plan_grows_the_units_until_the_grid_fits():
    """Fewer resident clusters than an even spread needs: more units per
    block, until the grid fits; the occupancy may depend on the block's
    shared memory."""
    even = ls.make_plan("fwd", 64, 1150, 132, 4, 33)
    assert (even["units_per_block"], even["clusters"]) == (9, 32)
    tight = ls.make_plan("fwd", 64, 1150, 132, 4, 30)
    assert (tight["units_per_block"], tight["clusters"]) == (10, 29)
    seen = []
    ls.make_plan("bwd", 64, 400, 132, 8,
                 lambda smem: seen.append(smem) or 15)
    assert seen and all(0 < s <= ls.SMEM_LIMIT for s in seen)


@pytest.mark.parametrize("kind,B,H,sms,cluster,cap,limit", [
    ("fwd", 64, 1150, 132, 1, 8, ls.SMEM_LIMIT),   # 144 units per block
    ("bwd", 1100, 1150, 132, 8, 15, ls.SMEM_LIMIT),  # the carry
    ("fwd", 64, 400, 132, 4, 30, 32 * 1024),        # a smaller card
    ("bwd", 3, 25, 8, 2, 0, ls.SMEM_LIMIT),         # no cluster resident
])
def test_plan_raises_where_the_weights_do_not_fit(kind, B, H, sms, cluster,
                                                  cap, limit):
    with pytest.raises(ValueError, match="lstm_scan"):
        ls.make_plan(kind, B, H, sms, cluster, cap, smem_limit=limit)


@pytest.mark.parametrize("bad", [dict(kind="mid"), dict(cluster=3),
                                 dict(B=0), dict(stages=1)])
def test_plan_rejects_bad_arguments(bad):
    args = dict(kind="fwd", B=4, H=24, sm_count=132, cluster=1,
                max_clusters=132, stages=4)
    args.update(bad)
    with pytest.raises(ValueError):
        ls.make_plan(**args)


@pytest.mark.parametrize("kind,H,want", [
    ("fwd", 24, 1), ("fwd", 130, 2), ("fwd", 400, 4), ("fwd", 1150, 4),
    ("bwd", 24, 1), ("bwd", 64, 4), ("bwd", 400, 8), ("bwd", 1150, 8)])
def test_default_cluster(kind, H, want):
    assert ls.default_cluster(kind, H) == want


def _source():
    return (build.CSRC / "lstm_scan.cu").read_text()


def _constant(text, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def test_constants_match_the_kernel_source():
    text = _source()
    assert int(_constant(text, "kThreads")) == ls.THREADS
    assert int(_constant(text, "kKTile")) == ls.K_TILE
    assert _constant(text, "kRingPitch") == "kKTile + 8"
    assert ls.RING_PITCH == ls.K_TILE + 8
    assert int(_constant(text, "kMaxRows")) == ls.MAX_ROWS
    assert int(_constant(text, "kMaxNTiles")) == ls.MAX_N_TILES


def test_plan_fields_match_the_kernel_enum():
    """The int[] the wrapper passes is read by the kernels' PlanField
    enum: same names, same order, same length."""
    body = re.search(r"enum PlanField \{(.*?)\};", _source(), re.S).group(1)
    names = re.findall(r"^\s*plan_(\w+)", body, re.M)
    assert names == [*ls.PLAN_FIELDS, "fields"]
    plan = ls.make_plan("fwd", 3, 24, 132, 1, 132)
    assert list(ls._plan_array(plan)) == [plan[f] for f in ls.PLAN_FIELDS]


def test_trace_edges_match_the_kernel_enum():
    """chip_smoke.py names the trace build's stamps by the kernels'
    TraceEdge enum."""
    import chip_smoke

    body = re.search(r"enum TraceEdge \{(.*?)\};", _source(), re.S).group(1)
    names = re.findall(r"^\s*edge_(\w+)", body, re.M)
    assert tuple(names) == chip_smoke.LSTM_TRACE_EDGES


def test_trace_phases_of_a_step():
    """The trace summary: phases end at the first stamp of their edge, the
    barrier runs from the stores to the next step, steps 2 to T - 2."""
    import chip_smoke

    edge = {n: i for i, n in enumerate(chip_smoke.LSTM_TRACE_EDGES)}
    stamps, t = [], 0
    for _ in range(5):
        for name, dt in (("step", 0), ("tile", 100), ("tile", 50),
                         ("multiplied", 30), ("partials", 20),
                         ("exchanged", 10), ("cell", 40), ("arrived", 5),
                         ("stored", 7)):
            t += dt
            stamps.append(t * 16 + edge[name])
        t += 200
    assert chip_smoke.lstm_trace_phases(stamps) == {
        "first_tile": 100, "multiplied": 80, "partials": 20,
        "exchanged": 10, "cell": 40, "arrived": 5, "stored": 7,
        "barrier": 200, "step_total": 462}
