"""The port's tracing (``utils/tracing.py``): off, it records nothing, enters
no profiler range and makes no hook or CUDA event, while the launch
counters count; on, spans carry their name, parent, thread and step,
appear once each among a profiler's host events, and one packed LM step
through the Learner gives the span tree of the port's layers with the
same loss and parameters as with tracing off."""

import contextlib
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.data.packing import pack_documents
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import transformer as tr
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
from neuralnetworklibrary_tpu_torch.utils import tracing

V, EOS, PAD, T = 50, 0, 1, 32
CFG = dict(vocab_size=V, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
           n_layers=2, d_ff=48, max_len=T, drop=0.0, pos_embedding="rope",
           rope_base=1e4, qk_norm=True, mlp="swiglu", norm="rmsnorm",
           reset_at=EOS, flash_attention=True)
FLASH = ("flash_fwd.launches", "flash_bwd_dq.launches",
         "flash_bwd_dkv.launches")


@pytest.fixture(autouse=True)
def _off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def fake_kernels(monkeypatch):
    """The flash wrappers on CPU tensors with kernels that do nothing, so
    their checks, launch counts and autograd Function run here."""
    lib = types.SimpleNamespace(**{n: (lambda *a: 0) for n in fa.SIGNATURES})
    monkeypatch.setitem(build.BOUND, "flash_attention", lib)
    monkeypatch.setattr(fa, "_shape_args", lambda *a: ())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def _flash_step():
    """K1 through the autograd Function, then its backward (K2, K3)."""
    q, k, v = (torch.randn(1, 8, 2, 16, requires_grad=True)
               for _ in range(3))
    fa._FlashAttention.apply(q, k, v, None, None, None, None, 0.25, True,
                             0, 0.0, 0).sum().backward()


def _learner(seed=0):
    torch.manual_seed(seed)
    model = tr.TransformerLM(**CFG, device="cpu")
    rng = np.random.default_rng(1)
    docs = [rng.integers(2, V, n).tolist() for n in rng.integers(1, 20, 12)]
    x, y, _ = pack_documents(docs, T, EOS, pad_token=PAD)
    dl = loader.DataLoader(loader.ArrayDataset(x[:4], y[:4]), 2, prefetch=0)
    data = types.SimpleNamespace(target_type="lang_model", bs=2,
                                 train_dl=dl, val_dl=dl)
    return Learner(tempfile.mkdtemp(), data, model, "Adam2",
                   loss_func=tr.PackedSeqCrossEntropyLoss(PAD), seed=0,
                   device="cpu")


def _train(learner, steps=2):
    batches = iter(learner.data.train_dl)
    return [learner.train1minibatch(next(batches), 1e-3)
            for _ in range(steps)]


def test_off_records_nothing_and_enters_nothing(monkeypatch, fake_kernels):
    def entered(*a, **kw):
        raise AssertionError("tracing off entered the profiler, made a "
                             "CUDA event or registered a hook")

    monkeypatch.setattr(tracing._profiler, "record_function", entered)
    monkeypatch.setattr(torch.cuda, "Event", entered)
    monkeypatch.setattr(torch.Tensor, "register_hook", entered)
    assert not tracing.enabled()
    assert tracing.span("a") is tracing._NULL
    assert tracing.span("b", device=True, step=3) is tracing._NULL
    with tracing.span("a") as sp:
        tracing.mark("m")
    assert sp is None
    _train(_learner())
    before = tracing.counters()
    _flash_step()
    after = tracing.counters()
    assert [after[k] - before[k] for k in FLASH] == [1, 1, 1]
    assert tracing.snapshot()["spans"] == []


def test_spans_nest_across_threads_with_their_step():
    tracing.enable()

    def worker():
        with tracing.span("worker"):
            time.sleep(0.001)
            tracing.mark("point")

    with tracing.span("step", step=7):
        with tracing.span("outer"):
            with tracing.span("inner"):
                time.sleep(0.001)
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
            assert not t.is_alive()
    with tracing.span("between"):
        pass
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    assert spans["step"]["parent"] is None
    assert spans["outer"]["parent"] == spans["step"]["id"]
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    # a thread with no span open hangs under the step thread's innermost
    assert spans["worker"]["parent"] == spans["outer"]["id"]
    assert spans["worker"]["thread"] != spans["outer"]["thread"]
    assert spans["point"]["parent"] == spans["worker"]["id"]
    assert spans["point"]["mark"] and spans["point"]["device_ms"] is None
    assert {spans[n]["step"] for n in ("step", "outer", "inner", "worker",
                                       "point")} == {7}
    assert spans["between"]["step"] == 8      # the step that follows
    assert set(spans["step"]["counters_in"]) == set(tracing.counters())

    def dur(s):
        return s["end_ns"] - s["start_ns"]

    o = spans["outer"]
    assert o["self_ns"] == dur(o) - dur(spans["inner"]) - dur(
        spans["worker"])
    assert spans["inner"]["self_ns"] == dur(spans["inner"]) > 0


def test_spans_sit_on_the_profilers_clock():
    """Under a recording profiler tracing is on by itself, and each span
    is one ``nnl/`` host event, nested as recorded, of the same length
    (after a first range, whose exit loads the profiler's operators)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("first"):
            pass
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("a"):
            time.sleep(0.002)
            with tracing.span("b"):
                time.sleep(0.001)
    assert not tracing.enabled()
    events = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("nnl/")}
    assert [e.name for e in prof.events()
            if e.name.startswith("nnl/")].count("nnl/a") == 1
    assert sorted(events) == ["nnl/a", "nnl/b"]
    a, b = events["nnl/a"], events["nnl/b"]
    assert a.start <= b.start and b.end <= a.end
    for s in tracing.snapshot()["spans"]:
        got = events["nnl/" + s["name"]].elapsed_us()
        want = (s["end_ns"] - s["start_ns"]) / 1e3
        assert abs(got - want) <= max(0.2 * want, 50.0), s["name"]


def test_a_packed_lm_step_gives_the_layer_tree_and_the_same_numbers():
    off = _learner()
    losses_off = _train(off)
    tracing.enable()
    on = _learner()
    losses_on = _train(on)
    tracing.disable()
    assert [float(v) for v in losses_on] == [float(v) for v in losses_off]
    for name, p in on.model.named_parameters():
        assert torch.equal(p, dict(off.model.named_parameters())[name]), name
    spans = tracing.snapshot()["spans"]
    by_id = {s["id"]: s for s in spans}
    step2 = [s for s in spans if s["step"] == 2]
    tree = sorted((by_id[s["parent"]]["name"] if s["parent"] else "",
                   s["name"]) for s in step2)
    assert tree == sorted([
        ("", "loader.next"), ("", "learner.step"),
        ("learner.step", "learner.h2d"), ("learner.step", "learner.forward"),
        ("learner.forward", "attention.fwd"),
        ("learner.forward", "attention.fwd"),
        ("learner.forward", "lm.head"), ("learner.step", "learner.loss"),
        ("learner.step", "learner.backward"),
        ("learner.backward", "lm.head.grad"),
        ("learner.step", "learner.optimizer")])
    opt = next(s for s in step2 if s["name"] == "learner.optimizer")
    assert opt["elements"] == sum(p.numel() for p in on.model.parameters()
                                  if p.requires_grad)
    assert opt["device_ms"] is None            # no CUDA events on the CPU


def test_the_flash_backward_span_and_counters(fake_kernels):
    tracing.enable()
    with tracing.span("learner.step", step=1):
        _flash_step()
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    step = spans["learner.step"]
    assert spans["attention.bwd"]["parent"] == step["id"]
    assert [step["counters_out"][k] - step["counters_in"][k]
            for k in FLASH] == [1, 1, 1]
    counters = tracing.counters()
    assert set(counters) == {
        "flash_fwd.launches", "flash_bwd_dq.launches",
        "flash_bwd_dkv.launches", "flash_bwd_dbias.launches",
        "lstm_fwd.launches", "lstm_bwd.launches", "paged_attention.launches",
        "padded_head.launches", "moe_experts.launches",
        "moe_experts.assignments", "adam.launches", "adam.elements"}
    from neuralnetworklibrary_tpu_torch.ops import lstm_scan, paged_attention

    assert counters["flash_bwd_dkv.launches"] == fa.flash_bwd_dkv.launches
    assert counters["lstm_bwd.launches"] == lstm_scan.lstm_bwd.launches
    assert (counters["paged_attention.launches"]
            == paged_attention.paged_attention.launches)
