"""The fused Adam step (``ops/adam.py``, ``csrc/adam.cu``) and the
optimizer's choice of it (``core/optim.py``).

On the CPU: the planner that cuts tensor lists into launches (the table's
limit, unit boundaries, 64-bit offsets); the choice of path (the CPU keeps
the foreach chain, whatever the dtype or layout); the wrapper refusing
what the kernel does not take; and the foreach chain against the JAX
optimizer over the run the card test makes: two layer groups, a clip, a
frozen leaf, a BatchNorm leaf without weight decay, two step counts in one
call and more tensors than one table holds.

On the card: the same run through the kernel against the foreach chain on
the CPU (so against the JAX optimizer, through the test above), to
``test_optimizer_matches_jax``'s tolerances; every trained element of a
transformer's Learner step going through the kernel; and the kernel's
time at Qwen3-0.6B's and SDAR-30B-A3B's trained elements against the
foreach chain and, as a yardstick only, ``torch._fused_adamw_``.  The card
tests run where no JAX is installed, so this file imports none at its top
(the JAX test skips there):

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_port_adam.py
"""

import ctypes
import json
import tempfile
import types

import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu_torch.core.optim import Optimizer, foreach_adam
from neuralnetworklibrary_tpu_torch.core.partition import Partition
from neuralnetworklibrary_tpu_torch.ops import adam as fused

RTOL, ATOL = 1e-5, 1e-7      # test_optimizer_matches_jax's


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


# ------------------------------------------------------------- the planner


def _covers(numels):
    """Each tensor's elements, from the units of every launch, in order:
    whole, once."""
    seen = {}
    for entries, units in fused.plan(numels):
        assert len(entries) <= fused.MAX_TENSORS
        assert 0 < units <= fused.MAX_UNITS
        for c in range(units):
            i, a, b = fused.unit_span(entries, numels, c)
            assert 0 <= a < b <= numels[i]
            seen.setdefault(i, []).append((a, b))
    for i, n in enumerate(numels):
        spans = seen.get(i, [])
        if n == 0:
            assert not spans
            continue
        assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
        assert spans[-1][1] == n


@pytest.mark.parametrize("numels", [
    [1], [3, 4097], [fused.CHUNK], [fused.CHUNK + 1, 0, 1],
    [2 * fused.CHUNK - 1, 5 * fused.CHUNK, 7],
    [0, 0], list(range(1, 3 * fused.MAX_TENSORS + 2))])
def test_the_units_cover_every_element_once(numels):
    _covers(numels)


def test_a_launch_holds_at_most_one_table():
    launches = fused.plan([5] * (2 * fused.MAX_TENSORS + 1))
    assert [len(e) for e, _ in launches] == [fused.MAX_TENSORS] * 2 + [1]
    assert [i for e, _ in launches for i, _ in e] == list(
        range(2 * fused.MAX_TENSORS + 1))
    assert [units for _, units in launches] == [fused.MAX_TENSORS] * 2 + [1]


def test_offsets_pass_two_to_the_31():
    n = 3 * 2 ** 31 + 5
    (entries, units), = fused.plan([7, n])
    assert units == 1 + -(-n // fused.CHUNK)
    assert fused.unit_span(entries, [7, n], 0) == (0, 0, 7)
    assert fused.unit_span(entries, [7, n], 1) == (1, 0, fused.CHUNK)
    i, a, b = fused.unit_span(entries, [7, n], units - 1)
    assert (i, b) == (1, n) and a > 2 ** 31 and b - a == n % fused.CHUNK
    c = 1 + 2 ** 31 // fused.CHUNK            # the unit that starts at 2^31
    assert fused.unit_span(entries, [7, n], c) == (
        1, 2 ** 31, 2 ** 31 + fused.CHUNK)


def test_a_launch_numbers_its_units_in_an_int():
    big = fused.MAX_UNITS * fused.CHUNK // 2
    launches = fused.plan([big, big, 1])
    assert [(len(e), u) for e, u in launches] == [
        (2, fused.MAX_UNITS), (1, 1)]
    with pytest.raises(ValueError, match="units"):
        fused.plan([fused.MAX_UNITS * fused.CHUNK + 1])


# ------------------------------------------------------- the optimizer's run

GROUP_LR, GROUP_WD, CLIP = [0.01, 0.05], [1e-2, 1e-3], 0.5
HEAD = 2 * fused.MAX_TENSORS + 10      # small leaves of group 1


def _run_leaves():
    """``{path: (shape, group, is_bn, trainable, storage offset)}``:
    sizes 1, 3, 4,097 and three units, one leaf 4 bytes off 16-byte
    alignment, a frozen leaf, a BatchNorm leaf, and more leaves in group 1
    than one table holds."""
    leaves = {("body", "one"): ((1,), 0, False, True, 0),
              ("body", "three"): ((3,), 0, False, True, 0),
              ("body", "odd"): ((17, 241), 0, False, True, 0),
              ("body", "units"): ((3, fused.CHUNK - 5), 0, False, True, 0),
              ("body", "unaligned"): ((37, 5), 0, False, True, 1),
              ("body", "frozen"): ((6, 4), 0, False, False, 0),
              ("body", "bn"): ((8,), 0, True, True, 0)}
    for k in range(HEAD):
        leaves[("head", f"w{k}")] = ((k % 7 + 1, 2), 1, False, True, 0)
    return leaves


def _starts_late(k, path):
    """Whether the run's ``k``-th leaf starts at step count 2."""
    return path[0] == "head" and k % 2 == 1


def _draws(steps, seed):
    """numpy values of ``seed`` for a run of :func:`_run_leaves`: each
    leaf's parameter, m, v and step count at the start, and each trained
    leaf's gradient at each of ``steps`` steps.  Half of group 1 starts at
    step count 2, so each of its steps has two step counts."""
    rng = np.random.default_rng(seed)
    leaves = _run_leaves()
    start = {}
    for k, (path, (shape, *_)) in enumerate(leaves.items()):
        start[path] = (rng.standard_normal(shape, np.float32),
                       0.1 * rng.standard_normal(shape, np.float32),
                       0.01 * rng.random(shape, np.float32),
                       2 if _starts_late(k, path) else 0)
    grads = [{path: rng.standard_normal(shape, np.float32)
              for path, (shape, _, _, t, _) in leaves.items() if t}
             for _ in range(steps)]
    return start, grads


def _partition(cls):
    """The run's Partition, of the port (or the JAX package's ``cls``)."""
    leaves = _run_leaves()
    return cls(paths=tuple(leaves),
               group_idx=tuple(v[1] for v in leaves.values()),
               is_bn=tuple(v[2] for v in leaves.values()),
               in_head=(False,) * len(leaves), n_groups=2)


def _trainable():
    return tuple(v[3] for v in _run_leaves().values())


def _run(device, steps=5, seed=0):
    """``steps`` Adam2 steps of :func:`_run_leaves` on ``device`` from
    :func:`_draws`, with the clip active: the parameters at the start, and
    the parameters and moments after each step, on the CPU."""
    start, grads = _draws(steps, seed)
    params, state = {}, {}
    opt = Optimizer("Adam2", bn_wd=False)
    for path, (p, m, v, t) in start.items():
        off = _run_leaves()[path][4]
        flat = torch.zeros(p.size + off, device=device)
        flat[off:] = torch.tensor(p.ravel())
        params[path] = flat[off:].view(p.shape)
    state = opt.init(params)
    for path, (_, m, v, t) in start.items():
        state[path]["m"].copy_(torch.tensor(m))
        state[path]["v"].copy_(torch.tensor(v))
        state[path]["t"] = t
    out = []
    for step in grads:
        opt.apply(params, {p: torch.tensor(g, device=device)
                           for p, g in step.items()},
                  state, _partition(Partition), _trainable(), GROUP_LR,
                  wd_groups=GROUP_WD, clip=CLIP)
        out.append({p: (params[p].cpu().clone(),
                        state[p]["m"].cpu().clone(),
                        state[p]["v"].cpu().clone()) for p in params})
    return {p: torch.tensor(v[0]) for p, v in start.items()}, out


def _run_jax(steps=5, seed=0):
    """The same steps through the JAX package's optimizer, in the form of
    :func:`_run`."""
    import jax
    import jax.numpy as jnp

    from neuralnetworklibrary_tpu.core.optim import Optimizer as JaxOptimizer
    from neuralnetworklibrary_tpu.core.partition import (
        Partition as JaxPartition,
    )

    start, grads = _draws(steps, seed)

    def tree(leaf):
        out = {}
        for path, value in start.items():
            out.setdefault(path[0], {})[path[1]] = leaf(path, value)
        return out

    params = tree(lambda path, v: jnp.asarray(v[0]))
    state = tree(lambda path, v: {"m": jnp.asarray(v[1]),
                                  "v": jnp.asarray(v[2]),
                                  "t": jnp.asarray(v[3], jnp.int32)})
    opt = JaxOptimizer("Adam2", bn_wd=False)
    apply = jax.jit(lambda params, gs, state: opt.apply(
        params, gs, state, _partition(JaxPartition), _trainable(),
        lr_groups=np.float32(GROUP_LR), wd_groups=np.float32(GROUP_WD),
        clip=CLIP))
    out = []
    for step in grads:
        gs = {}
        for path, g in step.items():
            gs.setdefault(path[0], {})[path[1]] = jnp.asarray(g)
        params, state = apply(params, gs, state)
        out.append({path: tuple(
            torch.tensor(np.asarray(x)) for x in (
                params[path[0]][path[1]], state[path[0]][path[1]]["m"],
                state[path[0]][path[1]]["v"])) for path in start})
    return {p: torch.tensor(v[0]) for p, v in start.items()}, out


def _sets():
    """The sizes of the trained leaves of each (group, step count) set of
    one step of the run."""
    sets = {}
    for k, (path, (shape, g, _, t, _)) in enumerate(_run_leaves().items()):
        if t:
            key = (g, _starts_late(k, path))
            sets.setdefault(key, []).append(int(np.prod(shape)))
    return sets


def _launches_a_step():
    return sum(len(fused.plan(n)) for n in _sets().values())


def _assert_same(got, want):
    """Both runs' parameters and moments at every step, to
    test_optimizer_matches_jax's tolerances; the frozen leaf's bits as they
    started."""
    (start, got), (_, want) = got, want
    for step, (a, b) in enumerate(zip(got, want)):
        for path in b:
            for name, x, y in zip("pmv", a[path], b[path]):
                np.testing.assert_allclose(
                    x.numpy(), y.numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"step {step} {path} {name}")
        assert torch.equal(a[("body", "frozen")][0], start[("body", "frozen")])


def test_the_foreach_chain_matches_jax():
    """The run the card test holds the kernel to, on the CPU's foreach
    chain, against the JAX package's optimizer: 5 steps with two layer
    groups, a clip, a frozen leaf, a BatchNorm leaf without weight decay,
    two step counts in one call and more than one table's tensors."""
    pytest.importorskip("jax", reason="the JAX package is the reference; "
                        "the card's machine has no JAX")
    assert max(len(n) for n in _sets().values()) > fused.MAX_TENSORS
    assert len(_sets()) == 3          # body; head at two step counts
    _assert_same(_run("cpu"), _run_jax())


def _one_leaf(p, g):
    opt = Optimizer("Adam2")
    params, grads = {("w",): p}, {("w",): g}
    state = opt.init(params)
    part = Partition(paths=(("w",),), group_idx=(0,), is_bn=(False,),
                     in_head=(False,), n_groups=1)
    opt.apply(params, grads, state, part, (True,), [0.01], wd_groups=[0.1],
              clip=0.5)
    return p


def test_the_cpu_keeps_the_foreach_chain():
    before = fused.adam.launches, fused.adam.elements
    _run("cpu", steps=1)
    assert (fused.adam.launches, fused.adam.elements) == before


@pytest.mark.parametrize("case", ["float32", "float64", "unlike",
                                  "transposed"])
def test_any_leaf_on_the_cpu_takes_the_foreach_chain(case):
    """On the CPU every leaf takes the foreach chain, whatever its dtype
    or layout, and the kernel's counters stay put; the step moves the
    parameter as the same step on a contiguous float64 copy does."""
    rng = np.random.default_rng(3)
    dtype = torch.float64 if case == "float64" else torch.float32
    p, g = (torch.tensor(rng.standard_normal((5, 4)), dtype=dtype)
            for _ in "pg")
    if case == "unlike":
        g = g.t().contiguous().t()
    elif case == "transposed":
        p, g = p.t(), g.t()
    want = _one_leaf(p.to(torch.float64, copy=True).contiguous(),
                     g.double().contiguous())
    before = fused.adam.launches, fused.adam.elements
    got = _one_leaf(p.clone(), g)
    assert (fused.adam.launches, fused.adam.elements) == before
    assert got.dtype == dtype
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


KW = dict(lr=0.1, b1=0.9, omb1=0.1, b2=0.99, omb2=0.01, bc1=0.1, bc2=0.01,
          eps=1e-8)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper raises, before any launch, on lists of unequal length,
    a float64 leaf, a gradient laid out unlike its parameter, a scale that
    is no float32 scalar, and (all else right, a channels_last leaf among
    them) the CPU's tensors."""
    p = torch.zeros(4, 3)
    kw = dict(lr=0.1, b1=0.9, omb1=0.1, b2=0.99, omb2=0.01, bc1=0.1,
              bc2=0.01, eps=1e-8)
    ok = [p], [p.clone()], [p.clone()], [p.clone()]
    conv = [torch.zeros(8, 3, 5, 5).to(memory_format=torch.channels_last)
            for _ in "pgmv"]
    before = fused.adam.launches, fused.adam.elements
    for match, args, scale in [
            ("length", (*ok[:3], []), None),
            ("float32", ([p.double()],) * 4, None),
            ("layout", (ok[0], [p.t().contiguous().t()], *ok[2:]), None),
            ("scale", ok, torch.ones(2)),
            ("CUDA", ok, None),
            ("CUDA", ([t] for t in conv), None)]:
        with pytest.raises(ValueError, match=match):
            fused.adam(*args, [1.0], scale=scale, **kw)
    assert not conv[0].is_contiguous()
    assert (fused.adam.launches, fused.adam.elements) == before


# ------------------------------------------------------------------ card


@pytest.mark.card
def test_the_kernel_matches_the_foreach_chain_on_the_card(card):
    """5 steps of the run through the kernel on the card against the
    foreach chain on the CPU; the frozen leaf keeps its bits; the launches
    are the planner's, more than one table's."""
    lib = fused.layout()
    assert lib == (fused.MAX_TENSORS, fused.CHUNK,
                   ctypes.sizeof(fused.Table)), lib
    want = _run("cpu")
    before = fused.adam.launches, fused.adam.elements
    got = _run(card)
    assert fused.adam.launches - before[0] == 5 * _launches_a_step()
    assert fused.adam.elements - before[1] == 5 * sum(
        sum(n) for n in _sets().values())
    _assert_same(got, want)


@pytest.mark.card
def test_every_trained_leaf_of_a_transformer_takes_the_kernel(card):
    """A Learner step of a bf16-autocast TransformerLM on the card: every
    trained element goes through the kernel, in one launch a layer
    group."""
    from neuralnetworklibrary_tpu_torch.data import loader
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM

    model = TransformerLM(vocab_size=64, d_model=128, n_heads=2, n_layers=2,
                          max_len=16, flash_attention=True, device=card)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 64, (4, 16))
    dl = loader.DataLoader(loader.ArrayDataset(x, np.roll(x, -1, axis=1)),
                           2, prefetch=0)
    data = types.SimpleNamespace(target_type="lang_model", bs=2,
                                 train_dl=dl, val_dl=dl)
    learner = Learner(tempfile.mkdtemp(), data, model, "Adam2", seed=0,
                      compute_dtype="bfloat16", device=card)
    before = fused.adam.launches, fused.adam.elements
    loss = learner.train1minibatch(next(iter(dl)), 1e-3)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert fused.adam.elements - before[1] == sum(
        p.numel() for p in model.parameters() if p.requires_grad)
    assert fused.adam.launches - before[0] == learner.partition.n_groups == 2


def _shapes(name):
    """The trained leaves of Qwen3-0.6B and of the SDAR-30B-A3B cell's
    stage (4 layers, every expert stacked, a quarter of the vocabulary)."""
    if name == "qwen3-0.6b":
        layer = [(2048, 1024), (1024, 1024), (1024, 1024), (1024, 2048),
                 (128,), (128,), (1024,), (1024,), (3072, 1024),
                 (3072, 1024), (1024, 3072)]
        return [(151936, 1024)] + layer * 28 + [(1024,)]
    layer = [(4096, 2048), (512, 2048), (512, 2048), (2048, 4096), (128,),
             (128,), (2048,), (2048,), (128, 2048), (128, 1536, 2048),
             (128, 2048, 768)]
    return [(37984, 2048)] + layer * 4 + [(2048,), (37984, 2048)]


def _time(fn, reps=5):
    """Device ms of one call of ``fn``: ``reps`` calls between two events,
    queued behind a sleep of the device so that the host's share of each
    call stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


@pytest.mark.card
@pytest.mark.parametrize("name", ["qwen3-0.6b", "sdar-30b-a3b"])
def test_the_kernels_time(card, name):
    """Device ms of one step over the cell's trained elements: the kernel
    (through ``Optimizer.apply``), the foreach chain (``foreach_adam``
    after the decay's foreach mul, as the CPU runs it) and
    ``torch._fused_adamw_`` (a yardstick the port never calls), against
    28 bytes an element over 3.35 TB/s."""
    g = torch.Generator(device=card).manual_seed(0)
    ps = [torch.randn(s, device=card, generator=g) for s in _shapes(name)]
    gs = [torch.randn(s, device=card, generator=g) for s in _shapes(name)]
    n = sum(p.numel() for p in ps)
    paths = tuple((f"w{k}",) for k in range(len(ps)))
    params, grads = dict(zip(paths, ps)), dict(zip(paths, gs))
    opt = Optimizer("Adam2")
    state = opt.init(params)
    part = Partition(paths=paths, group_idx=(0,) * len(paths),
                     is_bn=(False,) * len(paths),
                     in_head=(False,) * len(paths), n_groups=1)
    ms = [s["m"] for s in state.values()]
    vs = [s["v"] for s in state.values()]

    def step():
        for s in state.values():
            s["t"] = 0
        opt.apply(params, grads, state, part, (True,) * len(paths), [3e-4],
                  wd_groups=[0.1])

    def chain():
        torch._foreach_mul_(ps, 1 - 0.1 * 3e-4)
        foreach_adam(ps, gs, ms, vs, lr=3e-4, b1=0.9, omb1=0.1, b2=0.99,
                     omb2=0.01, bc1=0.1, bc2=0.01, eps=1e-8)

    before = fused.adam.launches
    kernel_ms = _time(step)
    launches = (fused.adam.launches - before) / 6
    assert all(torch.isfinite(p).all() for p in ps)
    foreach_ms = _time(chain)
    steps = [torch.ones((), device=card) for _ in ps]   # the callers' t
    try:
        library_ms = _time(lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9, beta2=0.99,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    except (AttributeError, RuntimeError, TypeError) as e:
        library_ms = f"unavailable: {e}"
    least_ms = 28 * n / 3.35e12 * 1e3
    line = {"shape": name, "elements": n, "tensors": len(ps),
            "launches_a_step": launches, "kernel_ms": kernel_ms,
            "foreach_ms": foreach_ms, "library_ms": library_ms,
            "least_ms": least_ms, "share": least_ms / kernel_ms,
            "kernel_tb_s": 28 * n / kernel_ms / 1e9,
            "device": torch.cuda.get_device_name(0)}
    print("adam timing:", json.dumps(line))
    assert kernel_ms < foreach_ms
