"""The cross-entropy of each logit row (``ops/cross_entropy.py``,
``csrc/cross_entropy.cu``), the losses that take it, the Learner's hand-off
of the model's own logits to them, and the padded head taking the
gradient's padded buffer in place.

On the CPU: the plain passes through ``seq_cross_entropy_loss``,
``SeqCrossEntropyLoss`` and ``PackedSeqCrossEntropyLoss`` against the JAX
package's, loss and gradient, at an odd vocabulary with pad targets, a row
mask and an all-masked batch, from float32 and bf16 logits; the gradient
in the logits' row layout; the padded head's backward taking that buffer
with no copy; and the Learner handing bf16 logits to the two CE losses and
float32 ones to ``RegSeqCrossEntropyLoss``.

On the card: the kernels against the plain passes at the stream cell's
padded shape (65,536 rows of 50,257 in a 50,304-element stride) and the
Qwen3 cells' (16,384 x 151,936), bf16 and float32; the upstream gradient
read on the device with no host synchronize; no float32 (N, V) tensor; the
padded head's buffer; two launches a training step; and the kernels' time
against their bound, the plain passes and PyTorch's float32 chain.  The
card tests run where no JAX is installed, so this file imports none at its
top (the JAX tests skip there):

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_port_cross_entropy.py
"""

import json
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.applications.text import (
    RegSeqCrossEntropyLoss,
    SeqCrossEntropyLoss,
)
from neuralnetworklibrary_tpu_torch.core.metrics import (
    seq_cross_entropy_loss,
)
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import transformer as tr
from neuralnetworklibrary_tpu_torch.ops import cross_entropy as ce
from neuralnetworklibrary_tpu_torch.ops import padded_head as ph

B, T, V, PAD = 3, 7, 37, 36          # odd V; the last id pads


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


@pytest.fixture
def jax_losses():
    """The JAX package's three losses (skips where JAX is missing, as on
    the card's machine)."""
    pytest.importorskip("jax")
    from neuralnetworklibrary_tpu.applications import text as jtext
    from neuralnetworklibrary_tpu.core import metrics as jm
    from neuralnetworklibrary_tpu.nn import transformer as jtr

    return {"seq_cross_entropy_loss": jm.seq_cross_entropy_loss,
            "SeqCrossEntropyLoss": jtext.SeqCrossEntropyLoss(),
            "PackedSeqCrossEntropyLoss": jtr.PackedSeqCrossEntropyLoss(PAD)}


PORT = {"seq_cross_entropy_loss": seq_cross_entropy_loss,
        "SeqCrossEntropyLoss": SeqCrossEntropyLoss(),
        "PackedSeqCrossEntropyLoss": tr.PackedSeqCrossEntropyLoss(PAD)}


def _draw(seed=0):
    """Logits (B, T, V) float32, targets with pad ids, a row mask."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (B, T, V)).astype(np.float32)
    y = rng.integers(0, V - 1, (B, T)).astype(np.int32)
    y[0, -3:] = PAD
    y[2, 1] = PAD
    return x, y


MASKS = {"none": None, "rows": np.array([1, 0, 1], np.float32),
         "all_masked": np.zeros(B, np.float32)}


def _bf16_ulp(v):
    """One bf16 ulp at each float32 value of ``v`` (the smallest normal's
    at 0)."""
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("loss", sorted(PORT))
def test_the_plain_passes_match_jax(jax_losses, loss, mask, dtype):
    """Loss and gradient of each loss against the JAX package's on the
    float32 values of the same logits: the loss to float32 round-off, the
    gradient to that too (float32 logits) or to one bf16 ulp (bf16 logits,
    whose gradient is the float32 one rounded once)."""
    import jax
    import jax.numpy as jnp

    x, y = _draw()
    m = MASKS[mask]
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    got = PORT[loss](xt, torch.from_numpy(y),
                     None if m is None else torch.from_numpy(m))
    got.backward()
    got = got.detach()
    assert got.dtype == torch.float32 and xt.grad.dtype == xt.dtype

    xj = xt.detach().float().numpy()

    def f(a):
        return jax_losses[loss](a, jnp.asarray(y),
                                None if m is None else jnp.asarray(m))

    want, gwant = jax.value_and_grad(f)(jnp.asarray(xj))
    want, gwant = float(want), torch.from_numpy(np.array(gwant))
    assert float(got) == pytest.approx(want, rel=2e-6, abs=1e-7)
    if mask == "all_masked":
        assert float(got) == 0.0 and not xt.grad.any()
    gap = (xt.grad.float() - gwant).abs()
    if dtype == "float32":
        assert (gap <= 1e-6 * gwant.abs() + 1e-8).all(), float(gap.max())
    else:
        assert (gap <= _bf16_ulp(gwant)).all(), float(gap.max())


def test_nll_is_logsumexp_less_the_targets_logit():
    x, y = _draw(1)
    got = ce.cross_entropy(torch.from_numpy(x), torch.from_numpy(y))
    xt = torch.from_numpy(x).double()
    want = (torch.logsumexp(xt, -1)
            - xt.gather(-1, torch.from_numpy(y).long()[..., None])[..., 0])
    assert got.shape == (B, T) and got.dtype == torch.float32
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=1e-6)


def test_the_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(B, T, V)
    with pytest.raises(ValueError, match="shape"):
        ce.cross_entropy(x, torch.zeros(B, T + 1, dtype=torch.long))
    with pytest.raises(RuntimeError):          # a target past V
        ce.cross_entropy(x, torch.full((B, T), V, dtype=torch.long))


def _padded(x, vp):
    """A (B, T, V) view of ``x``'s values whose rows are ``vp`` apart,
    the pad columns NaN, as the padded head's logits lie."""
    buf = torch.full((B * T, vp), float("nan"), dtype=x.dtype)
    buf[:, :V] = x.reshape(-1, V)
    return buf.view(B, T, vp)[..., :V]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_rows_are_read_in_place_and_the_gradient_keeps_them(dtype):
    """Logits whose rows are Vp apart are read where they lie (no copy) and
    their gradient is the (B, T, V) view of a (B T, Vp) buffer, with the
    values of contiguous logits' gradient."""
    x, y = _draw(2)
    xc = torch.from_numpy(x).to(dtype)
    vp = ph.padded_vocab(V)
    xp = _padded(xc, vp).requires_grad_()
    mat, ld = ce.rows(xp)
    assert ld == vp and mat.data_ptr() == xp.data_ptr()
    loss = seq_cross_entropy_loss(xp, torch.from_numpy(y))
    (g,) = torch.autograd.grad(loss, xp)
    assert g.shape == (B, T, V) and g.stride() == (T * vp, vp, 1)
    assert g.untyped_storage().nbytes() == B * T * vp * g.element_size()
    xc.requires_grad_()
    want = seq_cross_entropy_loss(xc, torch.from_numpy(y))
    (gw,) = torch.autograd.grad(want, xc)
    assert float(loss.detach()) == float(want.detach())
    assert torch.equal(g, gw)
    assert gw.is_contiguous()


def test_rows_copy_only_what_does_not_merge():
    x = torch.randn(4, 6, V)
    assert ce.rows(x)[1] == V and ce.rows(x)[0].data_ptr() == x.data_ptr()
    sliced = x[:, :5]                         # rows of two strides
    mat, ld = ce.rows(sliced)
    assert ld == V and mat.is_contiguous()
    assert torch.equal(mat, sliced.reshape(-1, V))
    assert ce.rows(x[:1, :1])[1] == V
    # rows too far apart for the kernels' int stride (a meta tensor: no
    # memory behind the 2**31-element stride)
    far = torch.empty_strided((2, 3, V), (ce.LD_LIMIT, V, 1), device="meta")
    assert ce.rows(far[:, -1])[1] == V
    near = torch.empty_strided((2, V), (ce.LD_LIMIT - 1, 1), device="meta")
    assert ce.rows(near)[1] == ce.LD_LIMIT - 1


@pytest.mark.parametrize("stale", [False, True])
def test_the_padded_head_takes_the_gradients_buffer(monkeypatch, stale):
    """Padded head, then the CE: the head's backward takes the CE's (N, Vp)
    gradient buffer as its own (``pad_rows`` is never called) and zeroes
    its pad columns, which held NaN where the buffer's memory was stale;
    dX and dW equal those of the copying path bit for bit."""
    x, y = _draw(3)
    g = torch.Generator().manual_seed(3)
    h = torch.randn(B, T, 16, generator=g).requires_grad_()
    w = torch.randn(V, 16, generator=g).requires_grad_()
    tgt = torch.from_numpy(y)

    logits = ph.padded_head(h, w)
    loss = tr.PackedSeqCrossEntropyLoss(PAD)(logits, tgt)
    (g,) = torch.autograd.grad(loss, logits, retain_graph=True)
    # the copying path: the same gradient, contiguous
    want = torch.autograd.grad(logits, (h, w), g.contiguous(),
                               retain_graph=True)
    copies = []
    pad_rows = ph.pad_rows
    monkeypatch.setattr(ph, "pad_rows",
                        lambda *a: copies.append(1) or pad_rows(*a))
    if stale:
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **kw: empty(
            *a, **kw).fill_(float("nan")))
    got = torch.autograd.grad(loss, (h, w))
    monkeypatch.undo()
    assert not copies
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_a_gradient_in_another_layout_is_copied():
    """A gradient that is not the view of an (N, Vp) buffer: none."""
    vp = ph.padded_vocab(V)
    assert ph.padded_buffer(torch.zeros(B, T, V), B * T, vp) is None
    g = torch.zeros(B * T, vp)[:, :V].view(B, T, V)
    assert ph.padded_buffer(g, B * T, vp).shape == (B * T, vp)
    assert ph.padded_buffer(g[:2], B * T, vp) is None   # other rows
    assert ph.padded_buffer(torch.zeros(B * T, vp + 64)[:, :V], B * T,
                            vp) is None


class _Spy:
    """Records the dtype of the logits its loss receives; keeps the
    loss's class attributes."""

    def __init__(self, loss, seen):
        self.loss, self.seen = loss, seen
        self.takes_model_dtype = getattr(loss, "takes_model_dtype", False)

    def __call__(self, outputs, target, mask=None):
        self.seen.append(outputs[0].dtype)
        return self.loss(outputs, target, mask)


@pytest.mark.parametrize("loss, want", [
    (SeqCrossEntropyLoss(), torch.bfloat16),
    (tr.PackedSeqCrossEntropyLoss(PAD), torch.bfloat16),
    (RegSeqCrossEntropyLoss(2.0, 1.0), torch.float32)])
def test_the_learner_hands_a_ce_the_models_own_logits(loss, want):
    """Under bf16 autocast the Learner's step hands the two CE losses the
    model's bf16 logits and a loss with other terms float32 copies; each
    step's loss is finite."""
    torch.manual_seed(0)
    model = tr.TransformerLM(vocab_size=V, d_model=32, n_heads=2,
                             n_layers=1, d_ff=64, max_len=8, drop=0.0,
                             flash_attention=False, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.integers(0, V, (4, 8))
    dl = loader.DataLoader(loader.ArrayDataset(x, np.roll(x, -1, axis=1)),
                           2, prefetch=0)
    data = types.SimpleNamespace(target_type="lang_model", bs=2,
                                 train_dl=dl, val_dl=dl)
    seen = []
    learner = Learner(tempfile.mkdtemp(), data, model, "Adam2",
                      loss_func=_Spy(loss, seen), seed=0,
                      compute_dtype="bfloat16", device="cpu")
    assert np.isfinite(float(learner.train1minibatch(next(iter(dl)), 1e-3)))
    assert seen == [want]


def test_the_kernel_source_is_in_the_build():
    """``csrc/cross_entropy.cu`` is one of the build's sources, so the
    interface test over every source checks its table."""
    assert "cross_entropy" in build.sources()
    assert build.source("cross_entropy").name == "cross_entropy.cu"


# ------------------------------------------------------------------ card

# (label, rows, V, row stride): the stream cell's padded logits and the
# Qwen3 cells'
SHAPES = [("gpt2_stream", 65536, 50257, 50304),
          ("qwen3", 16384, 151936, 151936)]
# and rows that start off 16-byte boundaries (GPT-2's logits as evaluation
# copies them, the AWD-LSTM's 30,001), and rows shorter than a vector
ODD = [("gpt2_contiguous", 4096, 50257, 50257),
       ("awd_lstm", 4800, 30001, 30001), ("tiny", 333, 3, 3)]
CHUNK = 4096                  # rows of a plain comparison at a time


def _card_logits(rows, vocab, ld, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.empty((rows, ld), dtype=dtype, device="cuda")
    buf[:, :vocab] = (3 * torch.randn((rows, vocab), generator=g,
                                      device="cuda")).to(dtype)
    buf[:, vocab:] = float("nan")
    t = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    return buf[:, :vocab], t


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label, rows, vocab, ld", SHAPES + ODD)
def test_the_kernels_match_the_plain_passes(card, label, rows, vocab, ld,
                                            dtype):
    """nll within float32 round-off of the plain pass, and the gradient
    (an upstream gradient of 3.7 / N a row) within one bf16 ulp of the
    plain pass's (float32: the log-sum-exp's round-off).  At a row's target
    the gradient is p d - d, which cancels where p nears 1: there the two
    sides' float32 p, apart by the log-sum-exp's round-off, may differ by
    up to ~1e-6 d, whatever the result's size."""
    x, t = _card_logits(rows, vocab, ld, dtype)
    assert ce.rows(x)[1] == ld
    xg = x.detach().requires_grad_()
    before = ce.cross_entropy.launches
    nll = ce.cross_entropy(xg, t)
    scale = torch.tensor(3.7 / rows, device=card)
    (g,) = torch.autograd.grad(nll.sum() * scale, xg)
    assert ce.cross_entropy.launches - before == 2
    assert g.dtype == dtype and g.stride() == (ld, 1)
    dnll = scale.expand(rows).contiguous()
    worst_nll = worst_g = 0.0
    for a in range(0, rows, CHUNK):
        xs, ts = x[a:a + CHUNK], t[a:a + CHUNK]
        lse, want = ce._plain_forward(xs, ts)
        worst_nll = max(worst_nll, float(((nll[a:a + CHUNK] - want).abs()
                                          / want.abs().clamp_min(1)).max()))
        gw = torch.empty_like(xs)
        ds = dnll[a:a + CHUNK]
        ce._plain_backward(xs, ts, lse, ds, gw)
        gap = (g[a:a + CHUNK].float() - gw.float()).abs()
        if dtype == torch.bfloat16:
            bound = _bf16_ulp(gw.float())
        else:           # the log-sum-exp's own round-off, ~1e-6 of it
            bound = 2e-5 * gw.abs() + 1e-12
        bound.scatter_add_(1, ts[:, None], 2e-6 * ds[:, None])
        worst_g = max(worst_g, float((gap / bound).max()))
    print(json.dumps({"test": "cross_entropy_vs_plain", "shape": label,
                      "dtype": str(dtype), "nll_rel_gap": worst_nll,
                      "grad_gap_in_bounds": worst_g}))
    assert worst_nll <= 2e-6
    assert worst_g <= 1.0


@pytest.mark.card
def test_no_host_sync_and_no_float32_copy(card):
    """A packed CE over the stream cell's padded bf16 logits, forward and
    backward, under ``set_sync_debug_mode("error")``: no host synchronize,
    and the peak over the loss and its backward is under one float32
    copy of the logits (the gradient buffer is half of one)."""
    rows, vocab, ld = SHAPES[0][1:]
    x, t = _card_logits(rows, vocab, ld, torch.bfloat16, seed=1)
    t[::7] = vocab - 1                                 # pad targets
    mask = torch.ones(rows // 1024, device=card)
    mask[3] = 0
    loss_fn = tr.PackedSeqCrossEntropyLoss(vocab - 1)
    xg = x.detach().view(rows // 1024, 1024, vocab).requires_grad_()
    tt = t.view(rows // 1024, 1024)
    torch.autograd.grad(loss_fn(xg, tt, mask), xg)    # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_fn(xg, tt, mask)
        (g,) = torch.autograd.grad(loss * 2.5, xg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    f32_copy = rows * vocab * 4
    print(json.dumps({"test": "cross_entropy_peak", "rise": rise,
                      "f32_copy": f32_copy}))
    assert rise < f32_copy, (rise, f32_copy)
    assert torch.isfinite(loss) and torch.isfinite(g).all()
    # the gradient of the masked row and of pad targets is zero
    assert not g[3].any() and not g.reshape(rows, vocab)[::7].any()


@pytest.mark.card
def test_the_padded_head_takes_the_kernels_buffer(card, monkeypatch):
    """GPT-2's head on the card: the CE kernel's gradient buffer is the
    padded head's (``pad_rows`` never called), and dX and dW equal the
    copying path's."""
    g = torch.Generator(device=card).manual_seed(5)
    h = torch.randn(8, 1024, 768, generator=g, device=card,
                    requires_grad=True)
    w = (0.02 * torch.randn(50257, 768, generator=g, device=card)
         ).requires_grad_()
    y = torch.randint(0, 50257, (8, 1024), generator=g, device=card)

    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits = ph.padded_head(h, w)
    loss = SeqCrossEntropyLoss()(logits, y)
    (g,) = torch.autograd.grad(loss, logits, retain_graph=True)
    want = torch.autograd.grad(logits, (h, w), g.contiguous(),
                               retain_graph=True)
    copies = []
    pad_rows = ph.pad_rows
    monkeypatch.setattr(ph, "pad_rows",
                        lambda *a: copies.append(1) or pad_rows(*a))
    got = torch.autograd.grad(loss, (h, w))
    assert not copies
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.card
def test_a_training_step_launches_two(card):
    """A Learner step of a bf16-autocast TransformerLM at an odd
    vocabulary (padded head) and an even one: two launches each."""
    for vocab in (1001, 1024):
        torch.manual_seed(0)
        model = tr.TransformerLM(vocab_size=vocab, d_model=128, n_heads=2,
                                 n_layers=2, max_len=64,
                                 flash_attention=True, device=card)
        rng = np.random.default_rng(1)
        x = rng.integers(0, vocab, (4, 64))
        dl = loader.DataLoader(loader.ArrayDataset(x, np.roll(x, -1, 1)),
                               2, prefetch=0)
        data = types.SimpleNamespace(target_type="lang_model", bs=2,
                                     train_dl=dl, val_dl=dl)
        learner = Learner(tempfile.mkdtemp(), data, model, "Adam2",
                          loss_func=SeqCrossEntropyLoss(), seed=0,
                          compute_dtype="bfloat16", device=card)
        before = ce.cross_entropy.launches
        loss = learner.train1minibatch(next(iter(dl)), 1e-3)
        torch.cuda.synchronize()
        assert np.isfinite(float(loss))
        assert ce.cross_entropy.launches - before == 2


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
@pytest.mark.parametrize("label, rows, vocab, ld", SHAPES)
def test_the_kernels_time(card, label, rows, vocab, ld):
    """Device ms of the forward and backward passes over the cell's bf16
    logits: the kernels, the plain passes, and PyTorch's chain on the
    float32 copy that the port ran before (cast, ``F.cross_entropy``, its
    backward, the cast back; a yardstick the port no longer calls),
    against 3 N V 2 bytes over 3.35 TB/s."""
    x, t = _card_logits(rows, vocab, ld, torch.bfloat16, seed=2)
    dnll = torch.full((rows,), 1.0 / rows, device=card)
    out = torch.empty((rows, ld), dtype=torch.bfloat16, device=card)
    lse = torch.empty(rows, device=card)
    nll = torch.empty(rows, device=card)
    code = ce.DTYPES[torch.bfloat16]

    def kernel_fwd():
        ce._launch("nnl_cross_entropy_fwd", x, x.data_ptr(), code, rows,
                   vocab, ld, t.data_ptr(), lse.data_ptr(), nll.data_ptr())

    def kernel_bwd():
        ce._launch("nnl_cross_entropy_bwd", x, x.data_ptr(), code, rows,
                   vocab, ld, t.data_ptr(), lse.data_ptr(), dnll.data_ptr(),
                   out.data_ptr(), ld)

    fwd_ms, bwd_ms = _time(kernel_fwd), _time(kernel_bwd)

    def plain():
        lse_p, _ = ce._plain_forward(x, t)
        ce._plain_backward(x, t, lse_p, dnll, out[:, :vocab])

    plain_ms = _time(plain, reps=2)

    def chain():
        xr = x.detach().requires_grad_()
        nll = F.cross_entropy(xr.float(), t, reduction="none")
        nll.backward(dnll)

    try:
        library_ms = _time(chain, reps=2)
    except torch.OutOfMemoryError as e:
        library_ms = f"unavailable: {e}"
    least_ms = 3 * rows * vocab * 2 / 3.35e12 * 1e3
    kernel_ms = fwd_ms + bwd_ms
    print(json.dumps({
        "test": "cross_entropy_time", "shape": label, "rows": rows,
        "vocab": vocab, "ld": ld, "device": torch.cuda.get_device_name(0),
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "kernel_ms": kernel_ms,
        "least_ms": least_ms, "share": least_ms / kernel_ms,
        "fwd_tb_s": rows * vocab * 2 / fwd_ms / 1e9,
        "bwd_tb_s": 2 * rows * vocab * 2 / bwd_ms / 1e9,
        "plain_ms": plain_ms, "library_ms": library_ms}))
    assert kernel_ms < plain_ms
