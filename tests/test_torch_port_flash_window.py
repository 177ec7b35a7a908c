"""K1-K3 with a causal window and packed rows at long context, on the card:
bf16 attention at B 1, T 32,768, 32 query heads over 4 kv heads (expanded
as the model expands them), head dim 128, each row's documents starting
at 0, 700 and 20,000, so the first 1,024-key windows of the second and
third documents cross a start.  The forward's output and the backward's
dq, dk, dv against a float32 computation of the same function in blocks
of queries (the plain version would hold (B, H, T, T) scores), within the
flash kernels' bf16 tolerance; and, while tracing is on, the call's
attended-pair counter against a host count.
The card tests run where no JAX is installed, so this file imports none:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_flash_window.py
"""

import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
from neuralnetworklibrary_tpu_torch.utils import tracing

B, T, H, HKV, HD = 1, 32768, 32, 4, 128
STARTS = (0, 700, 20000)
BLOCK = 512                       # queries of a float32 block
# the flash kernels' bf16 tolerance (chip_smoke.py FLASH_TOL):
# |got - want| <= ATOL + RTOL |want|
ATOL, RTOL = 3e-2, 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def doc_starts():
    """(B, T) int32 document starts of :data:`STARTS`."""
    qs = np.zeros(T, np.int32)
    for s in STARTS:
        qs[s:] = s
    return torch.from_numpy(np.tile(qs, (B, 1)))


def host_pairs(qs, window):
    """The attended (query, key) pairs of one head: query t sees keys
    max(q_start, t - window + 1) .. t."""
    t = np.arange(T)
    lo = np.asarray(qs, np.int64)
    if window:
        lo = np.maximum(lo, t - window + 1)
    return int((t - lo + 1).sum())


@torch.no_grad()
def blocked(q, k, v, do, qs, window):
    """(o, dq, dk, dv) in float32, BLOCK queries at a time over the keys
    from the block's first query's window start (or 0)."""
    q, k, v, do = (t.float().transpose(1, 2) for t in (q, k, v, do))
    scale = HD ** -0.5
    o, dq = torch.zeros_like(q), torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for a in range(0, T, BLOCK):
        b = a + BLOCK
        lo = max(0, a - window + 1) if window else 0
        t = torch.arange(a, b, device=q.device)[:, None]
        key = torch.arange(lo, b, device=q.device)[None]
        ok = (key <= t) & (key >= qs[:, a:b, None].long()).squeeze(0)
        if window:
            ok &= t - key < window
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, a:b], k[:, :, lo:b])
        s = (s * scale).masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, -1)
        ob = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, lo:b])
        o[:, :, a:b] = ob
        dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, a:b], v[:, :, lo:b])
        delta = (do[:, :, a:b] * ob).sum(-1, keepdim=True)
        ds = p * (dp - delta)
        dq[:, :, a:b] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                     k[:, :, lo:b]) * scale
        dk[:, :, lo:b] += torch.einsum("bhqk,bhqd->bhkd", ds,
                                       q[:, :, a:b]) * scale
        dv[:, :, lo:b] += torch.einsum("bhqk,bhqd->bhkd", p, do[:, :, a:b])
    return tuple(t.transpose(1, 2) for t in (o, dq, dk, dv))


def _within(got, want, name):
    diff = (got.float() - want.float()).abs()
    room = ATOL + RTOL * want.float().abs()
    worst = float((diff / room).max())
    assert worst <= 1.0, f"{name}: {worst:.3g} of the tolerance"


@pytest.mark.card
@pytest.mark.parametrize("window", [1024, 0])
def test_window_and_document_starts_at_32k(card, window):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        g = torch.Generator(card).manual_seed(window + 1)

        def draw(heads):
            return torch.randn(B, T, heads, HD, device=card, generator=g,
                               dtype=torch.float32).to(torch.bfloat16)

        q, do = draw(H), draw(H)
        k, v = (draw(HKV).repeat_interleave(H // HKV, dim=2)
                for _ in "kv")
        qs = doc_starts().to(card)
        q.requires_grad_(True)
        k.requires_grad_(True)
        v.requires_grad_(True)
        tracing.reset()
        before = {n: int(c) for n, c in fa.attended_pairs().items()}
        tracing.enable()
        try:
            o = fa.flash_attention(q, k, v, window=window, q_start=qs)
            o.backward(do)
            torch.cuda.synchronize()
        finally:
            tracing.disable()
        got = {n: int(c) - before[n] for n, c in fa.attended_pairs().items()}
        kind = "sliding" if window else "full"
        assert got[kind] == host_pairs(doc_starts()[0].numpy(), window)
        assert got["full" if window else "sliding"] == 0
        want = blocked(q.detach(), k.detach(), v.detach(), do, qs, window)
        for name, a, b in zip(("o", "dq", "dk", "dv"),
                              (o, q.grad, k.grad, v.grad), want):
            _within(a, b, name)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
