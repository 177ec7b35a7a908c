"""Decoder-only transformer LM: training (packed rows included), and dense
and paged KV-cached decode.

Counterpart of ``neuralnetworklibrary_tpu/nn/transformer.py`` for the
training and serving paths: :func:`rope_scaling_tuple` and :func:`rope`,
:class:`CausalSelfAttention`, :class:`MLP`, :class:`MoEMLP`,
:class:`TransformerBlock`, :class:`TransformerLM`, :func:`init_cache`, and
the losses :class:`FusedSeqCrossEntropyLoss` and
:class:`PackedSeqCrossEntropyLoss`.
Module attribute names are the flax parameter names (``word_embed``,
``pos_embed``, ``lm_head``, ``block_{i}.ln1``, ``.attn.qkv``,
``.attn.q_norm``, ``.attn.k_norm``, ``.attn.out``, ``.ln2``,
``.mlp.fc_in``, ``.mlp.fc_gate``, ``.mlp.fc_out``, an expert layer's
``.moe.gate``, ``.moe.w1`` ... ``.moe.b3``, ``ln_f``), so carrying
weights over from the JAX package is a renaming
(``utils.jax_params.load_jax_params``).

The modern decoder (Llama, Qwen3): ``pos_embedding='rope'`` (rotary
phases on q and k in the split-half convention, with the HF long-context
frequency rescalings and partial rotary), ``head_dim`` apart from
``d_model // n_heads``, ``qk_norm`` (a per-head RMSNorm on q and k before
the phases), ``mlp='swiglu'``, an untied ``lm_head``.  Under autocast the
q/k norms and the phases run in the projection's dtype, as the JAX bf16
Learner runs them.  Packed rows: ``reset_at`` (a separator token id)
restarts attention and positions after each separator; the model derives
each token's segment and position on the device, and the flash path takes
the document starts as the kernels' ``q_start``.

The KV cache is a nested dict of tensors that decode calls UPDATE IN PLACE
(the JAX package returns a new cache instead).  Which attention path a
layer takes follows the cache it is handed: ``k``/``v`` strips (B, max_len,
Hkv, hd) for dense decode, ``pool_k``/``pool_v`` (blocks, block, Hkv, hd)
for paged decode.  A paged model therefore prefills through a dense
batch-1 cache (``init_cache(model, 1, paged=False)``) without a clone.

Paged decode of one token per slot goes through the hand-written CUDA
kernel (``ops.paged_attention``) when ``paged_attention`` is True (the
default); else, and for T > 1, through the plain gather path.

Full-sequence attention takes the flash path (``ops.flash_attention``, the
CUDA flash kernels on CUDA tensors) when the model's ``flash_attention``
says so, as the JAX dispatch (transformer.py:574-599) does; else the
einsum path.  Dropout (embeddings, attention probabilities, MLP output)
runs only when a call passes ``train=True``, as the JAX ``__call__(x,
train=...)`` does: ``model.train()`` alone does not switch it on.  The
attention-probability dropout of the flash path is the kernels' hash mask,
seeded per call by an int32 drawn from the ``generator`` given (else from
torch's default CPU generator); every other dropout uses torch's RNG, so it
is statistically, not bitwise, the JAX model's.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neuralnetworklibrary_tpu_torch.ops.cross_entropy import cross_entropy
from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
    flash_attention,
    use_flash,
)
from neuralnetworklibrary_tpu_torch.ops.moe import moe_experts, moe_route
from neuralnetworklibrary_tpu_torch.ops.padded_head import (
    padded_head,
    pads_head,
)
from neuralnetworklibrary_tpu_torch.ops.paged_attention import paged_attention
from neuralnetworklibrary_tpu_torch.utils import tracing

_NEG_INF = -1e30
_TODO = "is not ported yet (ROADMAP Queue 1)"


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names a device; no card and no device
    named is an error, never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def rope_scaling_tuple(cfg, head_dim: int, base: float, max_len: int,
                       original_max: int = 0):
    """An HF ``rope_scaling`` config dict as the static tuple :func:`rope`
    takes (JAX ``rope_scaling_tuple``, transformer.py:61): ("linear",
    factor); ("yarn", factor, orig_max, beta_fast, beta_slow,
    attention_factor, truncate); ("llama3", factor, low_freq_factor,
    high_freq_factor, orig_max); ("longrope", switch, short_factor,
    long_factor, attention_factor), whose short/long choice is made per
    call from the largest position.  ``original_max`` is the top-level
    ``original_max_position_embeddings`` of configs (Phi-3) that keep it
    outside the dict.  None for a null or default config."""
    if cfg is None:
        return None
    if isinstance(cfg, tuple):
        return cfg
    kind = cfg.get("rope_type") or cfg.get("type") or "default"
    if kind == "default":
        return None
    orig = int(cfg.get("original_max_position_embeddings")
               or original_max or 0)
    if kind == "linear":
        return ("linear", float(cfg["factor"]))
    if kind == "yarn":
        # transformers' _compute_yarn_parameters: orig falls back to
        # max_position_embeddings; the attention factor may use the
        # DeepSeek mscale pair; truncate floors/ceils the correction range
        factor = float(cfg.get("factor", 1.0))
        orig_y = int(cfg.get("original_max_position_embeddings")
                     or max_len)
        att = cfg.get("attention_factor")
        if att is None:
            mscale = cfg.get("mscale")
            msall = cfg.get("mscale_all_dim")

            def gm(scale, m=1.0):
                return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

            att = (float(gm(factor, mscale) / gm(factor, msall))
                   if mscale and msall else gm(factor))
        return ("yarn", factor, orig_y,
                float(cfg.get("beta_fast") or 32.0),
                float(cfg.get("beta_slow") or 1.0), float(att),
                bool(cfg.get("truncate", True)))
    if kind == "llama3":
        return ("llama3", float(cfg["factor"]),
                float(cfg.get("low_freq_factor", 1.0)),
                float(cfg.get("high_freq_factor", 4.0)),
                int(cfg.get("original_max_position_embeddings") or orig
                    or max_len))
    if kind == "longrope":
        short = tuple(float(v) for v in cfg["short_factor"])
        long = tuple(float(v) for v in cfg["long_factor"])
        if len(short) != head_dim // 2 or len(long) != head_dim // 2:
            raise ValueError(
                f"longrope factors must have head_dim/2={head_dim // 2} "
                f"entries, got {len(short)}/{len(long)}")
        att = cfg.get("attention_factor")
        if att is None:
            # Phi-3 (_compute_longrope_parameters): the top-level
            # original_max_position_embeddings overrides the dict's factor
            f = (max_len / original_max if original_max
                 else float(cfg.get("factor") or 1.0))
            log_base = original_max or max_len
            att = (math.sqrt(1.0 + math.log(f) / math.log(log_base))
                   if f > 1.0 else 1.0)
        return ("longrope", int(original_max or max_len), short, long,
                float(att))
    raise ValueError(f"unsupported rope_scaling type {kind!r}")


def _rope_freqs(hd: int, base: float, scaling):
    """(inv_freq (hd/2,) float64, or the (short, long) pair of longrope;
    the attention factor; longrope's switch length or None) for a
    :func:`rope_scaling_tuple`."""
    inv = base ** (-np.arange(0, hd // 2) * 2.0 / hd)
    if scaling is None:
        return inv, 1.0, None
    kind = scaling[0]
    if kind == "linear":
        return inv / scaling[1], 1.0, None
    if kind == "yarn":
        # NTK-by-parts: a ramp between the interpolated (inv / factor) and
        # the extrapolated (inv) frequencies
        _, factor, orig, beta_fast, beta_slow, att, truncate = scaling

        def correction_dim(n_rot):
            return (hd * math.log(orig / (n_rot * 2 * math.pi))
                    / (2 * math.log(base)))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, hd - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(hd // 2) - low) / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp
        return (inv / factor) * (1.0 - extrap) + inv * extrap, att, None
    if kind == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2 * math.pi / inv
        smooth = np.clip((orig / wavelen - low_f) / (high_f - low_f),
                         0.0, 1.0)
        mid = (1.0 - smooth) * inv / factor + smooth * inv
        out = np.where(wavelen < orig / high_f, inv,
                       np.where(wavelen > orig / low_f, inv / factor, mid))
        return out, 1.0, None
    if kind == "longrope":
        _, orig, short, long, att = scaling
        return (inv / np.asarray(short), inv / np.asarray(long)), att, orig
    raise ValueError(f"unknown rope scaling tuple {scaling!r}")


def rope(x, positions, base: float = 10000.0, scaling=None,
         rotary_dim: int = 0):
    """Rotary position embedding in the split-half convention (JAX
    ``rope``, transformer.py:194): feature i pairs with i + hd/2 and turns
    by position * inv_freq[i].  x (B, T, H, hd); positions (T,) or (B, T)
    integers, on x's device.  ``scaling`` a :func:`rope_scaling_tuple`;
    ``rotary_dim`` > 0 turns only the first rotary_dim features (partial
    rotary), the rest pass through.  Computed in x's dtype, the angles in
    float32."""
    hd = x.shape[-1]
    if rotary_dim and rotary_dim != hd:
        if not 0 < rotary_dim < hd:
            raise ValueError(f"rotary_dim {rotary_dim} must lie in "
                             f"(0, head_dim={hd})")
        return torch.cat([rope(x[..., :rotary_dim], positions, base,
                               scaling), x[..., rotary_dim:]], -1)
    if hd % 2:
        raise ValueError(f"rope needs an even head dim, got {hd}")
    inv_np, att, orig = _rope_freqs(hd, base, scaling)
    f32 = dict(dtype=torch.float32, device=x.device)
    if orig is not None:  # longrope: short or long frequencies per call
        short, long = (torch.as_tensor(np.asarray(s), **f32)
                       for s in inv_np)
        if positions.ndim == 2:   # each row picks its own regime
            use_long = (positions.amax(-1) + 1 > orig)[:, None, None]
            inv_freq = torch.where(use_long, long, short)   # (B, 1, hd/2)
        else:
            inv_freq = torch.where(positions.max() + 1 > orig, long, short)
    else:
        inv_freq = torch.as_tensor(inv_np, **f32)
    ang = positions.to(torch.float32)[..., None] * inv_freq  # (.., T, hd/2)
    if positions.ndim == 1:
        ang = ang[None]
    cos = (torch.cos(ang) * att)[:, :, None, :].to(x.dtype)
    sin = (torch.sin(ang) * att)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _draw_seed(generator) -> int:
    """An int32 flash dropout seed from ``generator`` (a CPU generator, or
    None for torch's default one)."""
    return int(torch.randint(-(1 << 31), 1 << 31, (), generator=generator))


class CausalSelfAttention(nn.Module):
    """Multi-head self-attention, causal unless ``causal=False`` (an
    encoder's bidirectional attention), with a fused qkv projection whose
    columns are ``[q (H*hd) | k (Hkv*hd) | v (Hkv*hd)]``.

    ``n_kv_heads`` < n_heads is grouped-query attention (query head h reads
    kv head h // (H/Hkv)); ``window`` > 0 lets query t see keys
    (t - window, t] (causal only); ``sinks`` adds a learned per-head logit
    that joins every softmax row and whose mass is discarded; ``drop`` is
    the attention-probability dropout of training calls.  ``head_dim``
    (0: d_model // n_heads) sets the per-head width, so q, k, v project to
    H * hd and Hkv * hd and ``out`` maps H * hd back to d_model;
    ``qk_norm`` RMS-normalizes each head's q and k (``q_norm``,
    ``k_norm``, one (hd,) scale each, eps ``norm_eps``) before ``use_rope``
    turns them by :func:`rope` (``rope_base``, ``rope_scaling``,
    ``rotary_dim``); K is cached after the turn.
    """

    def __init__(self, d_model: int, n_heads: int, *, n_kv_heads: int = 0,
                 window: int = 0, sinks: bool = False, drop: float = 0.0,
                 causal: bool = True, head_dim: int = 0,
                 qk_norm: bool = False, norm_eps: float = 1e-6,
                 use_rope: bool = False, rope_base: float = 10000.0,
                 rope_scaling=None, rotary_dim: int = 0, device=None):
        super().__init__()
        self.drop = drop
        self.causal = causal
        H, Hkv = n_heads, n_kv_heads or n_heads
        if H % Hkv:
            raise ValueError(f"n_heads {H} must be a multiple of "
                             f"n_kv_heads {Hkv}")
        self.n_heads, self.n_kv_heads = H, Hkv
        self.head_dim = head_dim or d_model // H
        self.window = window
        self.use_rope, self.rope_base = use_rope, rope_base
        self.rope_scaling, self.rotary_dim = rope_scaling, rotary_dim
        hd = self.head_dim
        self.qkv = nn.Linear(d_model, (H + 2 * Hkv) * hd, device=device)
        self.out = nn.Linear(H * hd, d_model, device=device)
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = nn.RMSNorm(hd, eps=norm_eps, device=device)
            self.k_norm = nn.RMSNorm(hd, eps=norm_eps, device=device)
        self.sink = (nn.Parameter(torch.empty(H, device=device).normal_(
            0, 0.02)) if sinks else None)

    def _expand(self, t):  # (B, S, Hkv, hd) -> (B, S, H, hd)
        rep = self.n_heads // self.n_kv_heads
        return t if rep == 1 else t.repeat_interleave(rep, dim=2)

    def _attend(self, q, k, v, mask, drop: float = 0.0, bias=None):
        """Masked softmax attention over explicit k/v; mask broadcasts to
        (B, H, T, S) and ``bias`` (the logit bias) is added before it;
        ``drop`` > 0 drops probabilities (torch RNG)."""
        att = torch.einsum("bqhd,bkhd->bhqk", q, self._expand(k)) \
            / math.sqrt(self.head_dim)
        if bias is not None:
            att = att + bias
        att = att.masked_fill(~mask, _NEG_INF)
        if self.sink is None:
            att = torch.softmax(att, dim=-1)
        else:
            s = self.sink.to(att.dtype)[None, :, None, None].expand(
                *att.shape[:3], 1)
            att = torch.softmax(torch.cat([att, s], -1), dim=-1)[..., :-1]
        if drop > 0.0:
            att = F.dropout(att, drop)
        out = torch.einsum("bhqk,bkhd->bqhd", att, self._expand(v))
        return out.reshape(q.shape[0], q.shape[1], -1)

    def _flash(self, q, k, v, train, generator, kv_mask, att_bias,
               q_start=None, dropout_seed=None):
        """Full-sequence attention through ``ops.flash_attention`` on the
        kv heads expanded to H (``expand_kv``, transformer.py:592); the
        dropout seed is ``dropout_seed``, else drawn from ``generator``."""
        rate, seed = 0.0, None
        if train and self.drop > 0.0:
            rate = self.drop
            seed = (_draw_seed(generator) if dropout_seed is None
                    else dropout_seed)
        out = flash_attention(q, self._expand(k), self._expand(v),
                              window=self.window, causal=self.causal,
                              bias=att_bias, sink=self.sink,
                              kv_mask=kv_mask, dropout=rate,
                              dropout_seed=seed, q_start=q_start)
        return out.reshape(q.shape[0], q.shape[1], -1)

    @staticmethod
    def _head_norm(norm, t):
        """A per-head RMSNorm in t's dtype (the scale cast to it)."""
        return F.rms_norm(t, norm.normalized_shape, norm.weight.to(t.dtype),
                          norm.eps)

    def _positions(self, T, offset, positions, device):
        """The rotary positions of this call: the packed rows' (B, T),
        else arange(T) from ``offset`` (an int, or a (B,) tensor of
        per-row offsets), else from 0."""
        if positions is not None:
            return positions
        pos = torch.arange(T, device=device)
        if offset is None:
            return pos
        if isinstance(offset, torch.Tensor):
            off = offset.to(device=device, dtype=torch.long)
            return off[:, None] + pos if off.ndim else off + pos
        return int(offset) + pos

    def _band(self, keys, q_pos):
        """keys (S,), q_pos (..., T) -> (..., T, S) attendable mask (all
        True when bidirectional)."""
        if not self.causal:
            return torch.ones(q_pos.shape + keys.shape, dtype=torch.bool,
                              device=keys.device)
        mask = keys <= q_pos[..., None]
        if self.window > 0:
            mask &= keys > q_pos[..., None] - self.window
        return mask

    def forward(self, x, cache: Optional[dict] = None, offset=None,
                block_table=None, paged_kernel: bool = True,
                train: bool = False, flash: bool = False, generator=None,
                kv_mask=None, att_bias=None, segment_ids=None,
                positions=None, dropout_seed=None):
        """x (B, T, D).  Without ``cache``: full-sequence attention, through
        the flash op when ``flash`` and the options allow (a bias shared by
        the batch; a window only when causal), with dropout when ``train``.
        With ``cache`` (this layer's dict): decode at ``offset`` — an int
        shared by all rows, or a (B,) tensor of per-row positions; K/V of
        the T new tokens are written into the cache in place first.

        ``kv_mask`` (B, T) bool makes False keys unattendable (a padded
        encoder source; full-sequence only).  ``att_bias`` (1|B, H, T, S)
        is added to the logits before masking (T5's relative positions);
        the paged path rejects it.

        Packed rows (full-sequence, causal only): ``segment_ids`` (B, T)
        keeps attention inside each document and ``positions`` (B, T) are
        the per-document positions (rotary phases, and the flash path's
        document starts ``arange(T) - positions``, as JAX's
        ``flash_packed_ok`` rule, transformer.py:571).  ``dropout_seed``
        fixes the flash dropout seed of this call."""
        B, T, _ = x.shape
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self.qkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, Hkv, hd)
        v = v.reshape(B, T, Hkv, hd)
        dev = x.device
        if self.q_norm is not None:
            q = self._head_norm(self.q_norm, q)
            k = self._head_norm(self.k_norm, k)
        if self.use_rope:
            pos = self._positions(T, offset, positions, dev)
            q = rope(q, pos, self.rope_base, self.rope_scaling,
                     self.rotary_dim)
            k = rope(k, pos, self.rope_base, self.rope_scaling,
                     self.rotary_dim)
        if cache is not None and (not self.causal or kv_mask is not None):
            raise ValueError("decode needs causal attention and no kv_mask")
        if segment_ids is not None and (cache is not None or not self.causal):
            raise ValueError("segment_ids need causal full-sequence "
                             "attention")
        flash_bias_ok = att_bias is None or (
            att_bias.shape[0] == 1 and tuple(att_bias.shape[-2:]) == (T, T))
        flash_packed_ok = segment_ids is None or positions is not None
        if (cache is None and flash and flash_bias_ok and flash_packed_ok
                and (self.causal or self.window <= 0)):
            q_start = (None if segment_ids is None
                       else torch.arange(T, device=dev) - positions)
            out = self._flash(q, k, v, train, generator, kv_mask, att_bias,
                              q_start, dropout_seed)
        elif cache is None:
            pos = torch.arange(T, device=dev)
            mask = self._band(pos, pos)
            if segment_ids is not None:
                # the causal mask within each document (block-diagonal)
                seg = segment_ids
                mask = (mask[None] & (seg[:, :, None] == seg[:, None, :])
                        )[:, None]
            if kv_mask is not None:
                mask = mask & kv_mask.bool()[:, None, None, :]
            out = self._attend(q, k, v, mask, self.drop if train else 0.0,
                               att_bias)
        elif "pool_k" in cache:
            if att_bias is not None:
                raise ValueError("att_bias is not supported in paged decode")
            out = self._paged(q, k, v, cache, offset, block_table,
                              paged_kernel)
        else:
            ck, cv = cache["k"], cache["v"]
            keys = torch.arange(ck.shape[1], device=dev)
            if isinstance(offset, torch.Tensor) and offset.ndim == 1:
                q_pos = offset.long()[:, None] + torch.arange(T, device=dev)
                rows = torch.arange(B, device=dev)[:, None]
                ck[rows, q_pos] = k
                cv[rows, q_pos] = v
                mask = self._band(keys, q_pos)[:, None]      # (B, 1, T, M)
            else:
                off = int(offset)
                ck[:, off:off + T] = k
                cv[:, off:off + T] = v
                mask = self._band(keys, off + torch.arange(T, device=dev))
            out = self._attend(q, ck, cv, mask, bias=att_bias)
        return self.out(out)

    def _paged(self, q, k, v, cache, offset, block_table, paged_kernel):
        """Paged decode: scatter this step's K/V at (table[b, pos // bs],
        pos % bs), then attend over the slot's blocks — through the kernel
        for one token per slot, else by gathering the strip."""
        if block_table is None:
            raise ValueError("a paged cache needs block_table= on every "
                             "decode call")
        B, T, H, hd = q.shape
        pk, pv = cache["pool_k"], cache["pool_v"]
        bs = pk.shape[1]
        dev = q.device
        off = torch.as_tensor(offset, dtype=torch.int32, device=dev)
        if off.ndim == 0:
            off = off.expand(B)
        offs = off.long()[:, None] + torch.arange(T, device=dev)  # (B, T)
        table = block_table.long()
        rows = table.gather(1, offs // bs)
        pk[rows, offs % bs] = k
        pv[rows, offs % bs] = v
        if T == 1 and paged_kernel:
            out = paged_attention(q[:, 0].contiguous(), pk, pv, block_table,
                                  off.contiguous(), window=self.window,
                                  sink=self.sink)
            return out.reshape(B, 1, H * hd)
        Mp = table.shape[1] * bs
        kf = pk[table].reshape(B, Mp, self.n_kv_heads, hd)
        vf = pv[table].reshape(B, Mp, self.n_kv_heads, hd)
        mask = self._band(torch.arange(Mp, device=dev), offs)[:, None]
        return self._attend(q, kf, vf, mask)


class MLP(nn.Module):
    """Feed-forward block: fc_in, the activation, fc_out, then dropout of
    rate ``drop`` in training calls.  ``act`` is 'gelu' (tanh-approximate
    unless ``exact_gelu``), 'relu' (T5 v1.0) or 'silu'; None is gelu, or
    silu when ``gated``.  ``gated`` multiplies the activation by a second
    projection, ``fc_gate`` (SwiGLU; GEGLU with act 'gelu')."""

    _ACTS = ("gelu", "relu", "silu")

    def __init__(self, d_model: int, d_ff: int, drop: float = 0.0,
                 act: Optional[str] = None, gated: bool = False,
                 exact_gelu: bool = False, device=None):
        super().__init__()
        if act is not None and act not in self._ACTS:
            raise ValueError(f"act must be one of {sorted(self._ACTS)}, "
                             f"got {act!r}")
        self.drop = drop
        self.act = act or ("silu" if gated else "gelu")
        self.exact_gelu = exact_gelu
        self.fc_in = nn.Linear(d_model, d_ff, device=device)
        self.fc_gate = (nn.Linear(d_model, d_ff, device=device) if gated
                        else None)
        self.fc_out = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x, train: bool = False):
        h = self.fc_in(x)
        if self.act == "gelu":
            h = F.gelu(h, approximate="none" if self.exact_gelu else "tanh")
        else:
            h = F.relu(h) if self.act == "relu" else F.silu(h)
        if self.fc_gate is not None:
            h = h * self.fc_gate(x)
        h = self.fc_out(h)
        return F.dropout(h, self.drop) if train and self.drop > 0.0 else h


class MoEMLP(nn.Module):
    """Dropless top-k mixture of SwiGLU experts (``ops.moe``): the JAX
    ``MoEMLP(gated=True, top_k=top_k, eval_dense=True)`` path
    (transformer.py:948), in training too.  The router ``gate`` (D,
    ``n_experts``) scores every expert; each token takes its ``top_k``,
    weighted by the softmax over their logits (HF ``norm_topk_prob``), and
    no token is dropped.  The layer holds ``experts`` = (first, last) of
    them (all by default): w1, w3 (E, D, d_ff), w2 (E, d_ff, D) and the
    biases b1, b3 (E, d_ff), b2 (E, D), flax's names and layouts, E =
    last - first.  Its output is the held experts' part of the result:
    under expert parallelism the other chips add the rest; slots routed
    elsewhere add nothing here.  The router runs in float32; the products
    in autocast's dtype where it is on, else the weights'.  There is no
    auxiliary loss (HF Qwen3-MoE's ``output_router_logits`` false)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 top_k: int, experts=None, device=None):
        super().__init__()
        first, last = experts if experts is not None else (0, n_experts)
        if not 0 <= first < last <= n_experts:
            raise ValueError(f"experts {experts} must be a non-empty range "
                             f"of the {n_experts}")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k must be in [1, {n_experts}], got "
                             f"{top_k}")
        self.top_k, self.first = top_k, first
        E = last - first

        def normal(*shape, fan_in):
            return nn.Parameter(torch.empty(shape, device=device).normal_(
                0.0, fan_in ** -0.5))

        self.gate = normal(d_model, n_experts, fan_in=d_model)
        self.w1 = normal(E, d_model, d_ff, fan_in=d_model)
        self.w3 = normal(E, d_model, d_ff, fan_in=d_model)
        self.w2 = normal(E, d_ff, d_model, fan_in=d_ff)
        self.b1 = nn.Parameter(torch.zeros(E, d_ff, device=device))
        self.b3 = nn.Parameter(torch.zeros(E, d_ff, device=device))
        self.b2 = nn.Parameter(torch.zeros(E, d_model, device=device))

    def forward(self, x, train: bool = False):
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else self.w1.dtype)
        flat = x.reshape(-1, x.shape[-1])
        w, idx = moe_route(flat, self.gate, self.top_k)
        out = moe_experts(flat, w, idx, self.w1, self.b1, self.w3, self.b3,
                          self.w2, self.b2, self.first, dtype)
        return out.view(x.shape)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x)) with a
    ``d_ff`` hidden width (0: 4*d_model); ``drop`` reaches the attention
    probabilities and the MLP output; ``act``, ``gated`` and
    ``exact_gelu`` go to the :class:`MLP`.  ``n_experts`` > 0 puts a
    :class:`MoEMLP` (``moe``: ``moe_top_k`` of them, holding
    ``moe_experts``, each ``d_ff`` wide) in the MLP's place.
    ``causal=False`` makes the attention bidirectional (an encoder stack,
    as ``nn.vit.ViT`` builds).  ``attn_kw`` (head_dim, qk_norm, use_rope,
    rope_base, rope_scaling, rotary_dim) go to the
    :class:`CausalSelfAttention`, with ``norm_eps``."""

    def __init__(self, d_model: int, n_heads: int, *, d_ff: int = 0,
                 drop: float = 0.0, n_kv_heads: int = 0, window: int = 0,
                 sinks: bool = False, rms_norm: bool = False,
                 norm_eps: float = 1e-6, act: Optional[str] = None,
                 gated: bool = False, exact_gelu: bool = False,
                 causal: bool = True, n_experts: int = 0,
                 moe_top_k: int = 2, moe_experts=None, device=None,
                 **attn_kw):
        super().__init__()
        norm = nn.RMSNorm if rms_norm else nn.LayerNorm
        self.ln1 = norm(d_model, eps=norm_eps, device=device)
        self.attn = CausalSelfAttention(d_model, n_heads,
                                        n_kv_heads=n_kv_heads, window=window,
                                        sinks=sinks, drop=drop, causal=causal,
                                        norm_eps=norm_eps, device=device,
                                        **attn_kw)
        self.ln2 = norm(d_model, eps=norm_eps, device=device)
        if n_experts:
            self.moe = MoEMLP(d_model, d_ff or 4 * d_model, n_experts,
                              moe_top_k, moe_experts, device=device)
        else:
            self.mlp = MLP(d_model, d_ff or 4 * d_model, drop, act=act,
                           gated=gated, exact_gelu=exact_gelu, device=device)

    def forward(self, x, cache=None, offset=None, block_table=None,
                paged_kernel: bool = True, train: bool = False,
                flash: bool = False, generator=None, segment_ids=None,
                positions=None, dropout_seed=None):
        x = x + self.attn(self.ln1(x), cache, offset, block_table,
                          paged_kernel, train, flash, generator,
                          segment_ids=segment_ids, positions=positions,
                          dropout_seed=dropout_seed)
        ff = self.moe if hasattr(self, "moe") else self.mlp
        return x + ff(self.ln2(x), train)


class TransformerLM(nn.Module):
    """Causal LM: token embeddings with learned position embeddings
    (``pos_embedding='learned'``) or rotary phases in every attention
    (``'rope'``), ``n_layers`` pre-norm blocks with a ``d_ff`` MLP (0:
    4*d_model; ``mlp`` 'gelu', or 'swiglu' / 'geglu' gated), final norm,
    and a decoder tied to the token embedding (or ``lm_head`` with
    ``tied_decoder=False``).  Returns (logits, h) like the JAX model, or
    (h, head) with ``fused_ce`` for :class:`FusedSeqCrossEntropyLoss` (the
    (B, T, V) logits never exist); decode always returns logits.  A
    full-sequence CUDA forward whose vocabulary leaves a bf16 row
    unaligned (GPT-2's 50,257) computes them against the head padded to a
    multiple of 64 rows (``ops.padded_head``): the same values, in a view
    whose row stride is the padded vocabulary.  ``drop`` (default 0.1, as
    in JAX) acts in calls with ``train=True``.

    ``head_dim`` (0: d_model // n_heads), ``qk_norm``, ``rope_base``,
    ``rope_scaling`` (a :func:`rope_scaling_tuple`) and ``rotary_dim`` go
    to every attention.  ``window_pattern`` (the JAX package's: one int a
    layer, 0 = full attention) overrides ``window`` layer by layer, as
    models that interleave sliding-window and full layers (HF
    ``layer_types``) ask.  ``rope_pattern`` gives layer i its own rotary
    phases: one entry a layer, each None (the model's ``rope_base`` and
    ``rope_scaling``) or a (base, scaling) pair, scaling a
    :func:`rope_scaling_tuple` or None (HF ``rope_parameters`` by layer
    type, e.g. YaRN on the full layers only).  ``reset_at`` (a separator
    token id) packs several documents into a row: a segment starts right
    after each separator and positions restart there; both are derived on
    the device from the tokens (JAX transformer.py:1435-1446), and decode
    ignores them.
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant; each block's flash
    dropout seed is drawn once, before the block, so the recompute
    replays it).

    ``flash_attention``: True sends full-sequence attention through
    ``ops.flash_attention`` (its CUDA kernels on the card, its plain version
    on the CPU), False through the einsum path, None (auto) through flash
    exactly where the CUDA kernels take the call (``ops.flash_attention.
    use_flash``: a CUDA input, float32 or bfloat16, head dim 64 or 128),
    else through the einsum path.  It is read at every call
    (:meth:`uses_flash`).
    ``pad_token`` is kept for the data side, as in JAX.  Layer groups for
    the Learner: ``layer_group_prefixes`` (backbone, then the decoder as
    head) and ``head_prefixes``.

    paged_kv_blocks > 0 makes decode use a shared paged KV pool of that
    many blocks of ``paged_kv_block`` tokens (row 0 is the trash block that
    unallocated table entries point at); serve it with
    ``serving.PagedServingEngine``.  ``paged_attention`` picks the CUDA
    kernel (True) or the gather path (False) for one-token paged decode;
    it is read at every call, so it may be flipped on a built model.
    ``device`` defaults to cuda (see :func:`resolve_device`); convert the
    dtype with ``.to(torch.bfloat16)``.

    ``n_experts`` > 0 makes every ``moe_every``-th block (the JAX rule:
    block i when (i + 1) % moe_every == 0) a :class:`MoEMLP` of
    ``n_experts`` ``d_ff``-wide SwiGLU experts (``mlp='swiglu'``), routed
    dropless top-``moe_top_k`` in training and inference alike, holding
    ``moe_experts`` = (first, last) of them (default all): one chip's share
    under expert parallelism, whose output is that share's part.

    Not ported yet, each raising ``NotImplementedError`` when set (ROADMAP
    Queue 1): ``embed_scale``, ``attn_softcap``,
    ``logit_softcap``, ``att_scale``, ``post_norm``, ``parallel_block``,
    ``head_bias``, ``capacity_factor`` (the JAX package's GShard routing,
    which drops a token past an expert's capacity), ``lora_rank``,
    ``mesh``, ``sp`` and ``cp``.
    """

    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 8,
                 n_layers: int = 4, max_len: int = 512, d_ff: int = 0,
                 drop: float = 0.1, pad_token: int = 1,
                 flash_attention: Optional[bool] = None,
                 n_kv_heads: int = 0, window: int = 0,
                 sinks: bool = False, norm: str = "layernorm",
                 norm_eps: float = 1e-6, paged_kv_blocks: int = 0,
                 paged_kv_block: int = 32, paged_attention: bool = True,
                 pos_embedding: str = "learned", rope_base: float = 10000.0,
                 rope_scaling=None, rotary_dim: int = 0, head_dim: int = 0,
                 qk_norm: bool = False, mlp: str = "gelu",
                 tied_decoder: bool = True, remat: bool = False,
                 fused_ce: bool = False, reset_at: Optional[int] = None,
                 embed_scale: float = 0.0, window_pattern=None,
                 rope_pattern=None, attn_softcap: float = 0.0,
                 logit_softcap: float = 0.0,
                 att_scale: float = 0.0, post_norm: bool = False,
                 parallel_block: bool = False, head_bias: bool = False,
                 n_experts: int = 0, moe_top_k: int = 2, moe_every: int = 2,
                 moe_experts=None, capacity_factor: Optional[float] = None,
                 lora_rank: int = 0, mesh=None, sp: bool = False,
                 cp: bool = False, device=None):
        super().__init__()
        if capacity_factor is not None:
            raise NotImplementedError(
                "TransformerLM(capacity_factor=...): the GShard capacity "
                "routing of the JAX package's training path, which drops "
                "tokens past an expert's capacity, is not ported (ROADMAP "
                "Queue 1); n_experts > 0 routes dropless top-k")
        if n_experts and mlp != "swiglu":
            raise NotImplementedError(
                f"TransformerLM(n_experts=..., mlp={mlp!r}): experts are "
                f"SwiGLU only in the port {_TODO}")
        for name, asked in (("embed_scale", embed_scale),
                            ("attn_softcap", attn_softcap),
                            ("logit_softcap", logit_softcap),
                            ("att_scale", att_scale),
                            ("post_norm", post_norm),
                            ("parallel_block", parallel_block),
                            ("head_bias", head_bias),
                            ("lora_rank", lora_rank),
                            ("mesh", mesh is not None), ("sp", sp),
                            ("cp", cp)):
            if asked:
                raise NotImplementedError(f"TransformerLM({name}=...) "
                                          f"{_TODO}")
        if norm not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"norm must be 'layernorm' or 'rmsnorm', got {norm!r}")
        for name, pattern in (("window_pattern", window_pattern),
                              ("rope_pattern", rope_pattern)):
            if pattern is not None and len(pattern) != n_layers:
                raise ValueError(f"{name} needs one entry per layer "
                                 f"({n_layers}), got {len(pattern)}")
        if rope_pattern is not None and pos_embedding != "rope":
            raise ValueError("rope_pattern needs pos_embedding='rope'")
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding must be 'learned' or 'rope', "
                             f"got {pos_embedding!r}")
        if mlp not in ("gelu", "swiglu", "geglu"):
            raise ValueError(f"mlp must be 'gelu', 'swiglu' or 'geglu', "
                             f"got {mlp!r}")
        dev = resolve_device(device)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_heads, self.n_layers, self.max_len = n_heads, n_layers, max_len
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = head_dim or d_model // n_heads
        self.paged_kv_blocks, self.paged_kv_block = (paged_kv_blocks,
                                                     paged_kv_block)
        self.paged_attention = paged_attention
        self.d_ff, self.drop, self.pad_token = d_ff, drop, pad_token
        self.flash_attention = flash_attention
        self.sinks = sinks
        self.pos_embedding, self.mlp = pos_embedding, mlp
        self.tied_decoder, self.remat = tied_decoder, remat
        self.fused_ce, self.reset_at = fused_ce, reset_at
        self.n_experts, self.moe_top_k = n_experts, moe_top_k
        self.moe_every, self.moe_experts = moe_every, moe_experts
        self.window_pattern = (tuple(int(w) for w in window_pattern)
                               if window_pattern is not None
                               else (window,) * n_layers)
        ropes = [(rope_base, rope_scaling) if r is None
                 else (float(r[0]), r[1])
                 for r in rope_pattern or (None,) * n_layers]
        self.word_embed = nn.Parameter(
            torch.empty(vocab_size, d_model, device=dev).normal_(0, 0.02))
        self.pos_embed = (nn.Parameter(
            torch.empty(max_len, d_model, device=dev).normal_(0, 0.02))
            if pos_embedding == "learned" else None)
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, d_ff=d_ff, drop=drop,
                n_kv_heads=n_kv_heads, window=self.window_pattern[i],
                sinks=sinks, rms_norm=norm == "rmsnorm", norm_eps=norm_eps,
                act="gelu" if mlp == "geglu" else None,
                gated=mlp != "gelu", head_dim=self.head_dim,
                qk_norm=qk_norm, use_rope=pos_embedding == "rope",
                rope_base=ropes[i][0], rope_scaling=ropes[i][1],
                rotary_dim=rotary_dim,
                n_experts=(n_experts if n_experts
                           and (i + 1) % max(1, moe_every) == 0 else 0),
                moe_top_k=moe_top_k, moe_experts=moe_experts, device=dev))
        self.ln_f = (nn.RMSNorm if norm == "rmsnorm" else nn.LayerNorm)(
            d_model, eps=norm_eps, device=dev)
        self.lm_head = (None if tied_decoder else nn.Parameter(
            torch.empty(vocab_size, d_model, device=dev).normal_(0, 0.02)))

    @property
    def head_prefixes(self):
        return ("word_embed",) if self.tied_decoder else ("lm_head",)

    @property
    def layer_group_prefixes(self):
        blocks = tuple(f"block_{i}" for i in range(self.n_layers))
        if not self.tied_decoder:
            # untied: the input embedding is backbone, the decoder is head
            return (("pos_embed", "ln_f", "word_embed") + blocks,
                    ("lm_head",))
        return (("pos_embed", "ln_f") + blocks, ("word_embed",))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def uses_flash(self, device_type: str) -> bool:
        """Whether a full-sequence forward of inputs on ``device_type``
        takes the flash path (``use_flash`` of the model's
        ``flash_attention``, its parameters' dtype or autocast's, and its
        head dim)."""
        return use_flash(self.flash_attention, device_type,
                         self.word_embed.dtype, self.head_dim)

    def packing(self, x):
        """(segment_ids, positions), both (B, T), of packed rows of tokens
        x: a segment starts right after each ``reset_at`` token, and
        positions count from 0 within it."""
        B, T = x.shape
        sep = torch.zeros_like(x, dtype=torch.bool)
        sep[:, 1:] = x[:, :-1] == self.reset_at
        idx = torch.arange(T, device=x.device)
        start = torch.cummax(torch.where(sep, idx, 0), dim=1).values
        return sep.long().cumsum(1), idx - start

    def forward(self, x, decode: bool = False, offsets=None,
                block_table=None, cache: Optional[dict] = None,
                train: bool = False, generator=None):
        """x (B, T) token ids.  ``decode=True`` needs ``cache`` (from
        :func:`init_cache`) and writes it in place.  Positions start at
        ``offsets``: an int for every row, or a (B,) tensor per row; by
        default at the cache's shared counter ``cache["idx"]``, which then
        advances by T.  Paged caches need ``block_table`` (B, MB) int32.
        ``train=True`` applies dropout; ``generator`` (a CPU
        ``torch.Generator``) seeds the flash kernels' dropout."""
        B, T = x.shape
        if T > self.max_len:
            raise ValueError(f"sequence length {T} > max_len {self.max_len}")
        h = self.word_embed[x]
        offset = seg = positions = None
        if decode:
            if cache is None:
                raise ValueError("decode=True needs cache= (init_cache)")
            if offsets is None:
                offset = cache["idx"]
                cache["idx"] = offset + T
            elif isinstance(offsets, torch.Tensor) and offsets.ndim == 1:
                offset = offsets
            else:
                offset = int(offsets)
            if self.pos_embed is not None and isinstance(offset, int):
                h = h + self.pos_embed[offset:offset + T][None]
            elif self.pos_embed is not None:
                h = h + self.pos_embed[offset.long()[:, None]
                                       + torch.arange(T, device=x.device)]
        elif self.reset_at is not None:
            seg, positions = self.packing(x)
            if self.pos_embed is not None:
                h = h + self.pos_embed[positions]
        elif self.pos_embed is not None:
            h = h + self.pos_embed[:T][None]
        if train and self.drop > 0.0:
            h = F.dropout(h, self.drop)
        flash = not decode and self.uses_flash(x.device.type)
        remat = self.remat and not decode and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks()):
            seed = (_draw_seed(generator)
                    if flash and train and self.drop > 0.0 else None)
            args = (h, cache[f"block_{i}"]["attn"] if decode else None,
                    offset, block_table, self.paged_attention, train, flash,
                    generator, seg, positions, seed)
            h = (checkpoint(blk, *args, use_reentrant=False) if remat
                 else blk(*args))
        h = self.ln_f(h)
        head = self.word_embed if self.lm_head is None else self.lm_head
        if (train and tracing.enabled() and torch.is_grad_enabled()
                and h.requires_grad):
            # h's gradient is ready once the loss's backward, the cast's
            # and the head's (dX and the tied dW, one node) are done
            h.register_hook(_head_input_grad)
        with tracing.span("lm.head", device=True):
            if self.fused_ce and not decode:
                return h, head
            if pads_head(h.device.type, head.shape[0], decode):
                return padded_head(h, head), h
            return F.linear(h, head), h


def _head_input_grad(grad):
    tracing.mark("lm.head.grad")


def init_cache(model: TransformerLM, bs: int,
               paged: Optional[bool] = None) -> dict:
    """Zeroed KV cache in the model's dtype and device, shaped like the
    flax cache tree: ``{"idx": 0, "block_{i}": {"attn": {...}}}``.

    paged (default: whether the model is paged) gives each layer
    ``pool_k``/``pool_v`` of (paged_kv_blocks, paged_kv_block, Hkv, hd),
    shared by all rows; else ``k``/``v`` strips of (bs, max_len, Hkv, hd).
    """
    if paged is None:
        paged = model.paged_kv_blocks > 0
    if paged and model.paged_kv_blocks <= 0:
        raise ValueError("a paged cache needs a model with paged_kv_blocks > 0")
    w = model.word_embed
    shape = ((model.paged_kv_blocks, model.paged_kv_block)
             if paged else (bs, model.max_len))
    shape += (model.n_kv_heads, model.head_dim)
    names = ("pool_k", "pool_v") if paged else ("k", "v")
    cache = {"idx": 0}
    for i in range(model.n_layers):
        cache[f"block_{i}"] = {"attn": {
            n: torch.zeros(shape, dtype=w.dtype, device=w.device)
            for n in names}}
    return cache


def token_mask(target, mask):
    """The loader's (B,) row mask, a (B, T) token mask, or None, as (B, T)
    float32."""
    if mask is None:
        return torch.ones(target.shape, dtype=torch.float32,
                          device=target.device)
    mask = mask.float()
    return mask[:, None].expand(target.shape) if mask.ndim == 1 else mask


class FusedSeqCrossEntropyLoss:
    """Sequence CE over the outputs (h, head) of ``TransformerLM(fused_ce=
    True)`` (JAX transformer.py:1656): the vocabulary streams in ``chunk``
    rows (``ops.chunked_ce``), so the (B, T, V) logits never exist.  The
    masked mean of the materialized CE, up to the order of the sums."""

    def __init__(self, chunk: int = 8192):
        self.chunk = chunk

    def __call__(self, outputs, target, mask=None):
        from neuralnetworklibrary_tpu_torch.ops.chunked_ce import (
            chunked_softmax_ce,
        )

        return chunked_softmax_ce(outputs[0], outputs[1], target,
                                  token_mask(target, mask), self.chunk)


class PackedSeqCrossEntropyLoss:
    """Sequence CE for packed rows (``data.packing.pack_documents`` and
    ``TransformerLM(reset_at=...)``; JAX transformer.py:1690): targets
    equal to ``pad_token`` are left out token by token, and the loader's
    (B,) row mask composes in.  The mean over a batch of packed rows equals
    the per-document mean over the same tokens.  A CE and nothing else, so
    the Learner hands it the model's own logits (bf16 under autocast),
    which ``ops.cross_entropy`` reads in float32."""

    takes_model_dtype = True

    def __init__(self, pad_token: int):
        self.pad_token = int(pad_token)

    def __call__(self, outputs, target, mask=None):
        preds = outputs[0] if isinstance(outputs, tuple) else outputs
        nll = cross_entropy(preds, target)
        w = (target != self.pad_token).float() * token_mask(target, mask)
        return (nll * w).sum() / w.sum().clamp_min(1.0)
