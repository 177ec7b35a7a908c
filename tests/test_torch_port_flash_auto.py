"""The models' auto flash rule (``ops.flash_attention.use_flash``): with
``flash_attention=None`` a full-sequence forward takes the flash path only
where the CUDA kernels take the call (a CUDA input, float32 or bfloat16,
head dim 64 or 128; sinks and packed rows included) and the model's einsum
path otherwise, as the JAX models' auto rule picks einsum where its kernels are
not the choice.  A CUDA input is faked by passing the device type; True
and False are taken as given, and True on a head dim the kernels do not
take raises in the kernels' wrapper.  CPU only, tiny models."""

import pytest
import torch

from neuralnetworklibrary_tpu_torch.nn.seq2seq import TransformerSeq2Seq
from neuralnetworklibrary_tpu_torch.nn.transformer import (
    CausalSelfAttention,
    TransformerLM,
)
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa

LM = dict(vocab_size=16, n_layers=1, max_len=8, device="cpu")


@pytest.mark.parametrize("kw, device_type, want", [
    ({}, "cuda", False),                            # default: hd 32
    (dict(n_heads=4), "cuda", True),                # hd 64
    (dict(n_heads=2), "cuda", True),                # hd 128
    (dict(n_heads=4, sinks=True), "cuda", True),    # sinks (K1's sink)
    (dict(n_heads=4, reset_at=0), "cuda", True),    # packed (q_start)
    (dict(n_heads=4), "cpu", False),                # a CPU input
    (dict(n_heads=4, flash_attention=False), "cuda", False),
    (dict(flash_attention=True), "cuda", True),     # as asked, at hd 32
    (dict(flash_attention=True), "cpu", True),
])
def test_lm_auto_rule(kw, device_type, want):
    assert TransformerLM(**LM, **kw).uses_flash(device_type) is want


@pytest.mark.parametrize("n_heads, want", [(8, False), (4, True)])
def test_seq2seq_auto_rule(n_heads, want):
    m = TransformerSeq2Seq(vocab_size=16, n_heads=n_heads, enc_layers=1,
                           dec_layers=1, max_src_len=8, max_len=8,
                           device="cpu")
    assert m.uses_flash("cuda") is want
    assert m.uses_flash("cpu") is False


@pytest.mark.parametrize("dtype, hd, want", [
    (torch.bfloat16, 64, True), (torch.float32, 128, True),
    (torch.float16, 64, False), (torch.bfloat16, 32, False),
    (torch.bfloat16, 128, True), (torch.float32, 64, True)])
def test_use_flash_auto_where_the_kernels_take_the_call(dtype, hd, want):
    assert fa.use_flash(None, "cuda", dtype, hd) is want
    assert fa.use_flash(None, "cpu", dtype, hd) is False
    assert fa.use_flash(True, "cuda", dtype, hd) is True
    assert fa.use_flash(False, "cuda", dtype, hd) is False


def test_forced_flash_at_hd32_raises_in_the_wrapper():
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, 32 ** -0.5)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse, 32 ** -0.5)


def test_forward_follows_the_rule(monkeypatch):
    """The forward asks uses_flash with the input's device type and sends
    attention where it says."""
    calls, asked = [], []
    real = CausalSelfAttention._flash

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(CausalSelfAttention, "_flash", spy)
    m = TransformerLM(**LM, n_heads=4)
    x = torch.zeros(1, 8, dtype=torch.long)
    m(x)
    assert calls == []                  # auto on a CPU input: einsum
    monkeypatch.setattr(m, "uses_flash",
                        lambda dev: asked.append(dev) or True)
    m(x)
    assert asked == ["cpu"] and calls == [1]
