"""The padded LM head product (``ops/padded_head.py``): ``F.linear``'s
logits, dX and dW at an unaligned vocabulary, a finite dX from a gradient
buffer whose pad columns held NaN, the pad copy, the guard, the call
counter, and a
Learner step through ``TransformerLM`` that gives the unpadded step's loss
and gradients.  On the card: a GPT-2-shaped training step, padded against
``F.linear``, and no ``align1`` GEMM in the padded step's trace.

The card test runs where no JAX is installed, so this file imports none:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_padded_head.py
"""

import tempfile
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.core.metrics import (
    seq_cross_entropy_loss,
)
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.learner import Learner, _to_f32
from neuralnetworklibrary_tpu_torch.nn import transformer as tr
from neuralnetworklibrary_tpu_torch.ops import padded_head as ph

B, T, D, V = 2, 5, 64, 1001


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, T, D, generator=g).requires_grad_()
    w = torch.randn(V, D, generator=g).requires_grad_()
    dy = torch.randn(B, T, V, generator=g)
    return h, w, dy


def _both(mode, h, w):
    """(padded, F.linear) logits: float32; under CPU autocast to bf16;
    bf16 tensors."""
    if mode == "autocast":
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return ph.padded_head(h, w), F.linear(h, w)
    if mode == "bfloat16":
        h, w = h.bfloat16(), w.bfloat16()
    return ph.padded_head(h, w), F.linear(h, w)


# (mode, the logits' tolerance, dX's and dW's tolerance over their largest)
MODES = [("float32", 0.0, 1e-6), ("autocast", 0.0, 1e-2),
         ("bfloat16", 0.0, 1e-2)]


@pytest.mark.parametrize("mode, tol, grad_tol", MODES)
def test_the_padded_product_is_f_linears(mode, tol, grad_tol):
    """The logits equal ``F.linear``'s with their shape and dtype, in a
    view of Vp-wide rows; dX and dW agree (float32 to its rounding: dX's
    sums run over Vp terms, the pad's zeros among them; bf16 within a
    bf16 ulp of the largest), and dW has V rows."""
    h, w, dy = _inputs()
    got, want = _both(mode, h, w)
    assert got.shape == want.shape == (B, T, V)
    assert got.dtype == want.dtype
    assert got.stride() == (T * ph.padded_vocab(V), ph.padded_vocab(V), 1)
    assert torch.allclose(got.float(), want.float(), rtol=0, atol=tol)
    grads = [torch.autograd.grad(out, (h, w), dy.to(out.dtype))
             for out in (got, want)]
    for (a, b), shape in zip(zip(*grads), ((B, T, D), (V, D))):
        assert a.shape == b.shape == shape and a.dtype == b.dtype
        assert (a - b).abs().max() <= grad_tol * b.abs().max()


def test_a_stale_pad_column_does_not_reach_dx(monkeypatch):
    """The backward's padded gradient buffer comes from ``torch.empty``;
    filled with NaN, as stale memory may be, dX stays finite, because the
    pad columns are zeroed before the products."""
    empty = torch.empty

    def stale(*args, **kw):
        return empty(*args, **kw).fill_(float("nan"))

    h, w, dy = _inputs()
    out = ph.padded_head(h, w)
    monkeypatch.setattr(torch, "empty", stale)
    dh, dw = torch.autograd.grad(out, (h, w), dy)
    monkeypatch.undo()
    assert torch.isfinite(dh).all() and torch.isfinite(dw).all()
    want = torch.autograd.grad(F.linear(h, w), (h, w), dy)
    assert (dh - want[0]).abs().max() <= 1e-6 * want[0].abs().max()


def test_the_pad_columns_are_zero_and_never_returned():
    h, w, _ = _inputs()
    out = ph.padded_head(h, w)
    base = out._base.reshape(B * T, -1)
    assert base.shape[1] == ph.padded_vocab(V) > V
    assert (base[:, V:] == 0).all()
    assert out.shape[-1] == V


@pytest.mark.parametrize("device, vocab, decode, want", [
    ("cuda", 50257, False, True),         # GPT-2, full sequence
    ("cuda", 151936, False, False),       # Qwen3: 1,187 x 128
    ("cuda", 50304, False, False),        # already a multiple of 64
    ("cuda", 32004, False, True),         # 4 mod 8: a bf16 row unaligned
    ("cpu", 50257, False, False),
    ("cuda", 50257, True, False),         # a decode step
])
def test_the_guard(device, vocab, decode, want):
    assert ph.pads_head(device, vocab, decode) is want


@pytest.mark.parametrize("vocab, want", [(50257, 50304), (1001, 1024),
                                         (64, 64), (151935, 151936)])
def test_the_padded_vocabulary(vocab, want):
    assert ph.padded_vocab(vocab) == want
    assert want % ph.PAD_MULTIPLE == 0


@pytest.mark.parametrize("rows, vocab, dtype, expand", [
    (6, 1001, torch.bfloat16, False),     # 23 pad columns
    (3, 1, torch.bfloat16, False),        # one column
    (4, 128, torch.bfloat16, False),      # no pad
    (5, 1001, torch.float32, False),
    (6, 1001, torch.bfloat16, True),      # an expanded gradient
])
def test_pad_rows_copies_and_zeroes_the_pad(rows, vocab, dtype, expand):
    """``pad_rows`` copies every gradient column into a buffer that held
    NaN and zeroes every pad column; an expanded (stride-0) gradient, as
    ``logits.sum().backward()`` gives, is copied as its values."""
    g = torch.randn(1 if expand else rows, vocab).to(dtype)
    if expand:
        g = g.expand(rows, vocab)
    vp = ph.padded_vocab(vocab)
    out = torch.full((rows, vp), float("nan"), dtype=dtype)
    assert ph.pad_rows(g.view(rows, 1, vocab), out) is out
    assert torch.equal(out[:, :vocab], g)
    assert (out[:, vocab:] == 0).all()


CFG = dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=16, drop=0.0, flash_attention=False)


def _learner(seed=0):
    torch.manual_seed(seed)
    model = tr.TransformerLM(**CFG, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.integers(0, V, (4, 16))
    y = np.roll(x, -1, axis=1)
    dl = loader.DataLoader(loader.ArrayDataset(x, y), 2, prefetch=0)
    data = types.SimpleNamespace(target_type="lang_model", bs=2,
                                 train_dl=dl, val_dl=dl)
    return Learner(tempfile.mkdtemp(), data, model, "Adam2", seed=0,
                   device="cpu")


def _train(learner):
    """Two steps' losses and the first step's gradients (from Adam's
    first moment, m = (1 - b1) g)."""
    batches = iter(learner.data.train_dl)
    losses = [float(learner.train1minibatch(next(batches), 1e-3))]
    grads = {k: s["m"].clone() for k, s in learner.opt_state.items()}
    losses.append(float(learner.train1minibatch(next(batches), 1e-3)))
    return losses, grads


def test_a_learner_step_through_the_padded_head(monkeypatch):
    """``TransformerLM`` takes the padded product where the guard holds
    (here forced on the CPU): a Learner step gives the unpadded step's
    loss and gradients, the next step its loss, and the counter reads one
    call a step."""
    want_losses, want = _train(_learner())
    monkeypatch.setattr(tr, "pads_head", lambda *args: True)
    before = ph.padded_head.launches
    got_losses, got = _train(_learner())
    assert ph.padded_head.launches - before == 2
    assert got_losses == pytest.approx(want_losses, rel=1e-6)
    scale = max(float(g.abs().max()) for g in want.values())
    for k in want:
        assert (got[k] - want[k]).abs().max() <= 1e-6 * scale, k


def test_the_learners_cast_of_strided_logits_is_contiguous():
    """``_to_f32`` makes the padded logits a contiguous float32 tensor of
    (B, T, V), as it makes contiguous logits today."""
    h, w, _ = _inputs()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = ph.padded_head(h, w)
    f = _to_f32(out)
    assert f.dtype == torch.float32 and f.is_contiguous()
    assert torch.equal(f, out.float())
    assert f.untyped_storage().nbytes() == B * T * V * 4


# ------------------------------------------------------------------ card


GPT2 = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12,
            d_ff=3072, max_len=1024, drop=0.0, flash_attention=False)


def _card_step(model, x, y, profile=False):
    """One bf16 autocast training step's loss, gradients and, with
    ``profile``, the names of its device kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    model.zero_grad(set_to_none=True)
    p = prof(activities=[ProfilerActivity.CUDA]) if profile else None
    if p is not None:
        p.__enter__()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits, _ = model(x, train=True)
    loss = seq_cross_entropy_loss(_to_f32(logits), y)
    loss.backward()
    torch.cuda.synchronize()
    names = []
    if p is not None:
        p.__exit__(None, None, None)
        names = [e.name for e in p.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    grads = {k: v.grad.float().clone() for k, v in model.named_parameters()}
    return float(loss), grads, names


@pytest.mark.card
def test_a_gpt2_step_on_the_card_pads_its_head(card, monkeypatch):
    torch.manual_seed(0)
    model = tr.TransformerLM(**GPT2, device=card)
    x = torch.randint(0, 50257, (8, 1024), device=card)
    y = torch.roll(x, -1, 1)
    before = ph.padded_head.launches
    _card_step(model, x, y)                       # warm-up
    loss, grads, names = _card_step(model, x, y, profile=True)
    assert ph.padded_head.launches - before == 2
    assert names, "the profiler saw no device kernel"
    assert not [n for n in names if "align1" in n], sorted(set(names))
    monkeypatch.setattr(tr, "pads_head", lambda *args: False)
    want_loss, want, _ = _card_step(model, x, y)
    assert ph.padded_head.launches - before == 2
    assert loss == pytest.approx(want_loss, rel=2e-3)
    for k, g in want.items():
        err = (grads[k] - g).norm() / g.norm().clamp_min(1e-30)
        assert err < 2e-2, (k, float(err))
