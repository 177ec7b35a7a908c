"""Decoder-only transformer LM: training, and dense and paged KV-cached
decode.

Counterpart of ``neuralnetworklibrary_tpu/nn/transformer.py`` for the
training and serving paths: :class:`CausalSelfAttention`, :class:`MLP`,
:class:`TransformerBlock`, :class:`TransformerLM` and :func:`init_cache`.
Module attribute names are the flax parameter names (``word_embed``,
``pos_embed``, ``block_{i}.ln1``, ``.attn.qkv``, ``.attn.out``, ``.ln2``,
``.mlp.fc_in``, ``.mlp.fc_out``, ``ln_f``), so carrying weights over from
the JAX package is a renaming (``utils.jax_params.load_jax_params``).

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

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
    flash_attention,
    use_flash,
)
from neuralnetworklibrary_tpu_torch.ops.paged_attention import paged_attention

_NEG_INF = -1e30


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names a device; no card and no device
    named is an error, never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CausalSelfAttention(nn.Module):
    """Multi-head self-attention, causal unless ``causal=False`` (an
    encoder's bidirectional attention), with a fused qkv projection whose
    columns are ``[q (H*hd) | k (Hkv*hd) | v (Hkv*hd)]``.

    ``n_kv_heads`` < n_heads is grouped-query attention (query head h reads
    kv head h // (H/Hkv)); ``window`` > 0 lets query t see keys
    (t - window, t] (causal only); ``sinks`` adds a learned per-head logit
    that joins every softmax row and whose mass is discarded; ``drop`` is
    the attention-probability dropout of training calls.
    """

    def __init__(self, d_model: int, n_heads: int, *, n_kv_heads: int = 0,
                 window: int = 0, sinks: bool = False, drop: float = 0.0,
                 causal: bool = True, device=None):
        super().__init__()
        self.drop = drop
        self.causal = causal
        H, Hkv = n_heads, n_kv_heads or n_heads
        if H % Hkv:
            raise ValueError(f"n_heads {H} must be a multiple of "
                             f"n_kv_heads {Hkv}")
        self.n_heads, self.n_kv_heads = H, Hkv
        self.head_dim = d_model // H
        self.window = window
        hd = self.head_dim
        self.qkv = nn.Linear(d_model, (H + 2 * Hkv) * hd, device=device)
        self.out = nn.Linear(H * hd, d_model, device=device)
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

    def _flash(self, q, k, v, train, generator, kv_mask, att_bias):
        """Full-sequence attention through ``ops.flash_attention`` on the
        kv heads expanded to H (``expand_kv``, transformer.py:592)."""
        rate, seed = 0.0, None
        if train and self.drop > 0.0:
            rate = self.drop
            seed = int(torch.randint(-(1 << 31), 1 << 31, (),
                                     generator=generator))
        out = flash_attention(q, self._expand(k), self._expand(v),
                              window=self.window, causal=self.causal,
                              bias=att_bias, sink=self.sink,
                              kv_mask=kv_mask, dropout=rate,
                              dropout_seed=seed)
        return out.reshape(q.shape[0], q.shape[1], -1)

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
                kv_mask=None, att_bias=None):
        """x (B, T, D).  Without ``cache``: full-sequence attention, through
        the flash op when ``flash`` and the options allow (a bias shared by
        the batch; a window only when causal), with dropout when ``train``.
        With ``cache`` (this layer's dict): decode at ``offset`` — an int
        shared by all rows, or a (B,) tensor of per-row positions; K/V of
        the T new tokens are written into the cache in place first.

        ``kv_mask`` (B, T) bool makes False keys unattendable (a padded
        encoder source; full-sequence only).  ``att_bias`` (1|B, H, T, S)
        is added to the logits before masking (T5's relative positions);
        the paged path rejects it."""
        B, T, _ = x.shape
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self.qkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, Hkv, hd)
        v = v.reshape(B, T, Hkv, hd)
        dev = x.device
        if cache is not None and (not self.causal or kv_mask is not None):
            raise ValueError("decode needs causal attention and no kv_mask")
        flash_bias_ok = att_bias is None or (
            att_bias.shape[0] == 1 and tuple(att_bias.shape[-2:]) == (T, T))
        if (cache is None and flash and flash_bias_ok
                and (self.causal or self.window <= 0)):
            out = self._flash(q, k, v, train, generator, kv_mask, att_bias)
        elif cache is None:
            pos = torch.arange(T, device=dev)
            mask = self._band(pos, pos)
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


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x)) with a
    ``d_ff`` hidden width (0: 4*d_model); ``drop`` reaches the attention
    probabilities and the MLP output; ``act``, ``gated`` and
    ``exact_gelu`` go to the :class:`MLP`.  ``causal=False`` makes the
    attention bidirectional (an encoder stack, as ``nn.vit.ViT`` builds)."""

    def __init__(self, d_model: int, n_heads: int, *, d_ff: int = 0,
                 drop: float = 0.0, n_kv_heads: int = 0, window: int = 0,
                 sinks: bool = False, rms_norm: bool = False,
                 norm_eps: float = 1e-6, act: Optional[str] = None,
                 gated: bool = False, exact_gelu: bool = False,
                 causal: bool = True, device=None):
        super().__init__()
        norm = nn.RMSNorm if rms_norm else nn.LayerNorm
        self.ln1 = norm(d_model, eps=norm_eps, device=device)
        self.attn = CausalSelfAttention(d_model, n_heads,
                                        n_kv_heads=n_kv_heads, window=window,
                                        sinks=sinks, drop=drop, causal=causal,
                                        device=device)
        self.ln2 = norm(d_model, eps=norm_eps, device=device)
        self.mlp = MLP(d_model, d_ff or 4 * d_model, drop, act=act,
                       gated=gated, exact_gelu=exact_gelu, device=device)

    def forward(self, x, cache=None, offset=None, block_table=None,
                paged_kernel: bool = True, train: bool = False,
                flash: bool = False, generator=None):
        x = x + self.attn(self.ln1(x), cache, offset, block_table,
                          paged_kernel, train, flash, generator)
        return x + self.mlp(self.ln2(x), train)


class TransformerLM(nn.Module):
    """Causal LM: token + learned position embeddings, ``n_layers`` pre-norm
    blocks with a ``d_ff`` GELU MLP (0: 4*d_model), final norm, decoder
    tied to the token embedding.  Returns (logits, h) like the JAX model.
    ``drop`` (default 0.1, as in JAX) acts in calls with ``train=True``.

    ``flash_attention``: True sends full-sequence attention through
    ``ops.flash_attention`` (its CUDA kernels on the card, its plain version
    on the CPU), False through the einsum path, None (auto) through flash
    exactly where the CUDA kernels take the call (``ops.flash_attention.
    use_flash``: a CUDA input, float32 or bfloat16, head dim 64 or 128, no
    sinks), else through the einsum path.  It is read at every call
    (:meth:`uses_flash`).
    ``pad_token`` is kept for the data side, as in JAX.  Layer groups for
    the Learner: ``layer_group_prefixes`` (backbone, then the tied
    embedding as head) and ``head_prefixes``.

    paged_kv_blocks > 0 makes decode use a shared paged KV pool of that
    many blocks of ``paged_kv_block`` tokens (row 0 is the trash block that
    unallocated table entries point at); serve it with
    ``serving.PagedServingEngine``.  ``paged_attention`` picks the CUDA
    kernel (True) or the gather path (False) for one-token paged decode;
    it is read at every call, so it may be flipped on a built model.
    ``device`` defaults to cuda (see :func:`resolve_device`); convert the
    dtype with ``.to(torch.bfloat16)``.
    """

    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 8,
                 n_layers: int = 4, max_len: int = 512, d_ff: int = 0,
                 drop: float = 0.1, pad_token: int = 1,
                 flash_attention: Optional[bool] = None,
                 n_kv_heads: int = 0, window: int = 0,
                 sinks: bool = False, norm: str = "layernorm",
                 norm_eps: float = 1e-6, paged_kv_blocks: int = 0,
                 paged_kv_block: int = 32, paged_attention: bool = True,
                 device=None):
        super().__init__()
        if norm not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"norm must be 'layernorm' or 'rmsnorm', got {norm!r}")
        dev = resolve_device(device)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_heads, self.n_layers, self.max_len = n_heads, n_layers, max_len
        self.n_kv_heads = n_kv_heads or n_heads
        self.paged_kv_blocks, self.paged_kv_block = (paged_kv_blocks,
                                                     paged_kv_block)
        self.paged_attention = paged_attention
        self.d_ff, self.drop, self.pad_token = d_ff, drop, pad_token
        self.flash_attention = flash_attention
        self.sinks = sinks
        self.word_embed = nn.Parameter(
            torch.empty(vocab_size, d_model, device=dev).normal_(0, 0.02))
        self.pos_embed = nn.Parameter(
            torch.empty(max_len, d_model, device=dev).normal_(0, 0.02))
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, d_ff=d_ff, drop=drop,
                n_kv_heads=n_kv_heads, window=window, sinks=sinks,
                rms_norm=norm == "rmsnorm", norm_eps=norm_eps, device=dev))
        self.ln_f = (nn.RMSNorm if norm == "rmsnorm" else nn.LayerNorm)(
            d_model, eps=norm_eps, device=dev)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def head_prefixes(self):
        return ("word_embed",)

    @property
    def layer_group_prefixes(self):
        blocks = tuple(f"block_{i}" for i in range(self.n_layers))
        return (("pos_embed", "ln_f") + blocks, ("word_embed",))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def uses_flash(self, device_type: str) -> bool:
        """Whether a full-sequence forward of inputs on ``device_type``
        takes the flash path (``use_flash`` of the model's
        ``flash_attention``, its parameters' dtype or autocast's, its head
        dim and its sinks)."""
        return use_flash(self.flash_attention, device_type,
                         self.word_embed.dtype, self.head_dim,
                         sink=self.sinks)

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
        offset = None
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
            if isinstance(offset, int):
                h = h + self.pos_embed[offset:offset + T][None]
            else:
                h = h + self.pos_embed[offset.long()[:, None]
                                       + torch.arange(T, device=x.device)]
        else:
            h = h + self.pos_embed[:T][None]
        if train and self.drop > 0.0:
            h = F.dropout(h, self.drop)
        flash = not decode and self.uses_flash(x.device.type)
        for i, blk in enumerate(self.blocks()):
            h = blk(h, cache[f"block_{i}"]["attn"] if decode else None,
                    offset, block_table, self.paged_attention, train, flash,
                    generator)
        h = self.ln_f(h)
        return F.linear(h, self.word_embed), h


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
