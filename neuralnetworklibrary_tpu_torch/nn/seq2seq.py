"""Encoder-decoder sequence-to-sequence transformer (BART and T5 layouts).

Counterpart of ``neuralnetworklibrary_tpu/nn/seq2seq.py``: the bucketed
relative positions :func:`t5_relative_bucket`, :class:`CrossAttention`,
:class:`EncoderBlock`, :class:`DecoderBlock`, :class:`TransformerSeq2Seq`,
the decoder cache :func:`init_seq2seq_cache`, the cached generation loop
:func:`seq2seq_generate`, :func:`seq2seq_collate` and
:class:`Seq2SeqCrossEntropyLoss`.  Module attribute names are the flax
names (``enc_block_{i}.attn.qkv``, ``dec_block_{i}.cross.kv``,
``enc_rel_bias``, ``lm_head``, ...), so ``utils.jax_params.
load_jax_params`` carries weights over by renaming.

The encoder's bidirectional self-attention (with the padded source's key
mask) and the decoder's causal self-attention take the flash path when the
model's ``flash_attention`` says so; T5's relative-position bias, one
(buckets, H) table per stack shared by its layers, rides the flash
kernels' batch-shared bias operand, and its gradient comes from the dbias
kernel.  Cross-attention is a plain einsum, as in JAX.  Generation is a
host loop over cached decode steps after one encoder pass and one
projection of the memory's K/V; the cache is a nested dict of tensors
updated in place.

Not ported yet: ``seq2seq_beam_search``, ``seq2seq_param_rule``, the int8
decoder cache (``kv_quant``) and the Whisper audio frontend
(``audio_frontend``), which raise NotImplementedError (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.nn.transformer import (
    MLP,
    CausalSelfAttention,
    resolve_device,
)
from neuralnetworklibrary_tpu_torch.ops.flash_attention import use_flash

_NEG_INF = -1e30
_TODO = "is not ported yet (ROADMAP Queue 1)"


def t5_relative_bucket(rel, bidirectional: bool, num_buckets: int = 32,
                       max_dist: int = 128):
    """T5 relative-position bucketing (Raffel et al. section 2.1) of signed
    distances ``rel = key_pos - query_pos``: half the buckets hold small
    exact distances, the rest are log-spaced out to ``max_dist``.
    Bidirectional splits the buckets between the two signs; causal buckets
    only the past and sends the future to bucket 0.  int32, as in JAX: a
    float32 log, then truncation."""
    rel = torch.as_tensor(rel).to(torch.int32)
    n = num_buckets
    buckets = torch.zeros_like(rel)
    if bidirectional:
        n //= 2
        buckets = buckets + (rel > 0).to(torch.int32) * n
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    large = max_exact + (
        torch.log(torch.clamp(rel, min=1).to(torch.float32) / max_exact)
        / math.log(max_dist / max_exact)
        * (n - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=n - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class CrossAttention(nn.Module):
    """Decoder-to-memory attention: queries from the target stream, K/V
    projected once from the encoder memory (:meth:`memory_kv`), padded
    source positions masked."""

    def __init__(self, d_model: int, n_heads: int, drop: float = 0.0,
                 device=None):
        super().__init__()
        self.n_heads, self.drop = n_heads, drop
        self.q = nn.Linear(d_model, d_model, device=device)
        self.kv = nn.Linear(d_model, 2 * d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def memory_kv(self, memory):
        """(B, S, D) encoder output -> ((B, S, H, hd), (B, S, H, hd))."""
        B, S, D = memory.shape
        k, v = self.kv(memory).chunk(2, dim=-1)
        H = self.n_heads
        return k.reshape(B, S, H, D // H), v.reshape(B, S, H, D // H)

    def forward(self, x, mk, mv, mem_mask, train: bool = False):
        B, T, D = x.shape
        H = self.n_heads
        q = self.q(x).reshape(B, T, H, D // H)
        att = torch.einsum("bqhd,bkhd->bhqk", q, mk) / math.sqrt(D // H)
        att = torch.softmax(
            att.masked_fill(~mem_mask[:, None, None, :], _NEG_INF), dim=-1)
        if train and self.drop > 0.0:
            att = F.dropout(att, self.drop)
        o = torch.einsum("bhqk,bkhd->bqhd", att, mv).reshape(B, T, D)
        return self.out(o)


def _make_norm(kind: str, eps: float, d_model: int, device=None):
    if kind == "rmsnorm":
        return nn.RMSNorm(d_model, eps=eps, device=device)
    if kind == "layernorm":
        return nn.LayerNorm(d_model, eps=eps, device=device)
    raise ValueError(f"norm must be 'layernorm' or 'rmsnorm', got {kind!r}")


class EncoderBlock(nn.Module):
    """Pre-norm bidirectional block over the padded source: the key mask
    keeps pad positions unattendable; ``att_bias`` is the stack's shared
    relative-position bias."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 drop: float = 0.0, norm: str = "layernorm",
                 norm_eps: float = 1e-6, mlp_act: Optional[str] = None,
                 gated_mlp: bool = False, exact_gelu: bool = False,
                 device=None):
        super().__init__()
        self.ln1 = _make_norm(norm, norm_eps, d_model, device)
        self.attn = CausalSelfAttention(d_model, n_heads, drop=drop,
                                        causal=False, device=device)
        self.ln2 = _make_norm(norm, norm_eps, d_model, device)
        self.mlp = MLP(d_model, d_ff, drop, act=mlp_act, gated=gated_mlp,
                       exact_gelu=exact_gelu, device=device)

    def forward(self, x, kv_mask, train: bool = False, att_bias=None,
                flash: bool = False, generator=None):
        x = x + self.attn(self.ln1(x), train=train, flash=flash,
                          generator=generator, kv_mask=kv_mask,
                          att_bias=att_bias)
        return x + self.mlp(self.ln2(x), train)


class DecoderBlock(nn.Module):
    """Pre-norm decoder block: causal self-attention (cached in decode),
    cross-attention into the encoder memory, MLP.  ``att_bias`` reaches the
    self-attention only (T5's cross-attention has no position bias)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 drop: float = 0.0, norm: str = "layernorm",
                 norm_eps: float = 1e-6, mlp_act: Optional[str] = None,
                 gated_mlp: bool = False, exact_gelu: bool = False,
                 device=None):
        super().__init__()
        self.ln1 = _make_norm(norm, norm_eps, d_model, device)
        self.self_attn = CausalSelfAttention(d_model, n_heads, drop=drop,
                                             device=device)
        self.ln2 = _make_norm(norm, norm_eps, d_model, device)
        self.cross = CrossAttention(d_model, n_heads, drop, device=device)
        self.ln3 = _make_norm(norm, norm_eps, d_model, device)
        self.mlp = MLP(d_model, d_ff, drop, act=mlp_act, gated=gated_mlp,
                       exact_gelu=exact_gelu, device=device)

    def forward(self, x, mk, mv, mem_mask, train: bool = False, cache=None,
                offset=None, att_bias=None, flash: bool = False,
                generator=None):
        x = x + self.self_attn(self.ln1(x), cache, offset, train=train,
                               flash=flash, generator=generator,
                               att_bias=att_bias)
        x = x + self.cross(self.ln2(x), mk, mv, mem_mask, train)
        return x + self.mlp(self.ln3(x), train)


class TransformerSeq2Seq(nn.Module):
    """Encoder-decoder LM over a shared source/target vocabulary; the
    constructor takes the JAX model's fields.

    Training call: ``model(src, tgt_in, train=, generator=)`` -> (logits,
    h); pair it with :class:`Seq2SeqCrossEntropyLoss` on the shifted
    targets that :func:`seq2seq_collate` builds.  Inference:
    :func:`seq2seq_generate`.

    ``pos_embedding`` 'learned' (BART: absolute position tables) or
    'relative' (T5: one (rel_buckets, H) bias table per stack);
    ``norm`` 'layernorm' or 'rmsnorm'; ``mlp_act``/``gated_mlp``/
    ``exact_gelu`` pick the MLP; ``tied_decoder`` False adds a separate
    (V, D) ``lm_head``; ``logit_scale`` multiplies the final hidden state
    before the head (tied T5: d_model ** -0.5).  ``flash_attention``: True
    sends the encoder's and the decoder's full-sequence self-attention
    through ``ops.flash_attention``, False through the einsum path, None
    (auto) through flash exactly where the CUDA kernels take the call
    (``ops.flash_attention.use_flash``: a CUDA input, float32 or bfloat16,
    head dim 64 or 128), else through the einsum path.
    Dropout acts only in calls with ``train=True``.  Layer groups for the
    Learner: [encoder, decoder, embeddings] (``layer_group_prefixes``,
    ``head_prefixes``).  ``device`` defaults to cuda (see
    :func:`resolve_device`).
    """

    def __init__(self, vocab_size: int, pad_token: int = 0,
                 d_model: int = 256, n_heads: int = 8, enc_layers: int = 4,
                 dec_layers: int = 4, d_ff: int = 0, max_src_len: int = 512,
                 max_len: int = 512, drop: float = 0.1,
                 kv_quant: bool = False,
                 flash_attention: Optional[bool] = None,
                 pos_embedding: str = "learned", rel_buckets: int = 32,
                 rel_max_dist: int = 128, norm: str = "layernorm",
                 norm_eps: float = 1e-6, mlp_act: Optional[str] = None,
                 gated_mlp: bool = False, tied_decoder: bool = True,
                 logit_scale: float = 1.0, audio_frontend: bool = False,
                 exact_gelu: bool = False, device=None):
        super().__init__()
        for name, asked in (("kv_quant", kv_quant),
                            ("audio_frontend", audio_frontend)):
            if asked:
                raise NotImplementedError(f"TransformerSeq2Seq({name}=True) "
                                          f"{_TODO}")
        if pos_embedding not in ("learned", "relative"):
            raise ValueError("pos_embedding must be 'learned' or "
                             f"'relative', got {pos_embedding!r}")
        dev = resolve_device(device)
        D, ff = d_model, d_ff or 4 * d_model
        self.vocab_size, self.pad_token, self.d_model = (vocab_size,
                                                         pad_token, d_model)
        self.n_heads, self.enc_layers, self.dec_layers = (n_heads, enc_layers,
                                                          dec_layers)
        self.max_src_len, self.max_len, self.drop = max_src_len, max_len, drop
        self.flash_attention = flash_attention
        self.pos_embedding = pos_embedding
        self.rel_buckets, self.rel_max_dist = rel_buckets, rel_max_dist
        self.tied_decoder, self.logit_scale = tied_decoder, logit_scale

        def table(*shape):
            return nn.Parameter(torch.empty(*shape, device=dev).normal_(
                0, 0.02))

        self.word_embed = table(vocab_size, D)
        if not tied_decoder:
            self.lm_head = table(vocab_size, D)
        if pos_embedding == "learned":
            self.enc_pos = table(max_src_len, D)
            self.dec_pos = table(max_len, D)
        else:
            self.enc_rel_bias = table(rel_buckets, n_heads)
            self.dec_rel_bias = table(rel_buckets, n_heads)
        blk_kw = dict(norm=norm, norm_eps=norm_eps, mlp_act=mlp_act,
                      gated_mlp=gated_mlp, exact_gelu=exact_gelu, device=dev)
        for i in range(enc_layers):
            self.add_module(f"enc_block_{i}",
                            EncoderBlock(D, n_heads, ff, drop, **blk_kw))
        self.enc_ln = _make_norm(norm, norm_eps, D, dev)
        for i in range(dec_layers):
            self.add_module(f"dec_block_{i}",
                            DecoderBlock(D, n_heads, ff, drop, **blk_kw))
        self.dec_ln = _make_norm(norm, norm_eps, D, dev)

    @property
    def head_prefixes(self):
        return (("word_embed",) if self.tied_decoder
                else ("word_embed", "lm_head"))

    @property
    def layer_group_prefixes(self):
        enc = tuple(f"enc_block_{i}" for i in range(self.enc_layers)) \
            + ("enc_pos", "enc_rel_bias", "enc_ln", "conv1", "conv2")
        dec = tuple(f"dec_block_{i}" for i in range(self.dec_layers)) \
            + ("dec_pos", "dec_rel_bias", "dec_ln")
        return (enc, dec, self.head_prefixes)

    def enc_blocks(self):
        return [getattr(self, f"enc_block_{i}")
                for i in range(self.enc_layers)]

    def dec_blocks(self):
        return [getattr(self, f"dec_block_{i}")
                for i in range(self.dec_layers)]

    def uses_flash(self, device_type: str) -> bool:
        """Whether full-sequence self-attention of inputs on
        ``device_type`` takes the flash path (``use_flash`` of the model's
        ``flash_attention``, its parameters' dtype or autocast's and its
        head dim)."""
        return use_flash(self.flash_attention, device_type,
                         self.word_embed.dtype, self.d_model // self.n_heads)

    def _rel_bias(self, table, q_pos, k_pos, bidirectional: bool):
        """Bucketed relative-position bias: q_pos (T,) or (B, T), k_pos
        (M,) -> contiguous (1|B, H, T, M) in the table's dtype, added to
        the attention logits.

        The lookup is a product with the buckets' one-hot rows, outside
        autocast, so it is exact: its backward is one small GEMM, where
        the backward of ``table[b]`` accumulates T*M rows into 32 with a
        sort (19.5 of a T5-base step's 121 ms of device time, H100)."""
        rel = k_pos[None, :] - q_pos[..., :, None]           # (..., T, M)
        b = t5_relative_bucket(rel, bidirectional, self.rel_buckets,
                               self.rel_max_dist)
        with torch.autocast(table.device.type, enabled=False):
            bias = F.one_hot(b.long(), self.rel_buckets).to(table.dtype) \
                @ table                                      # (..., T, M, H)
        bias = bias.movedim(-1, -3).contiguous()             # (..., H, T, M)
        return bias if bias.ndim == 4 else bias[None]

    def encode(self, src, train: bool = False, generator=None):
        """(B, S) padded source ids -> ((B, S, D) memory, (B, S) bool mask
        of the source's real positions)."""
        B, S = src.shape
        if S > self.max_src_len:
            raise ValueError(f"source length {S} > max_src_len "
                             f"{self.max_src_len}")
        mask = src != self.pad_token
        h = self.word_embed[src]
        bias = None
        if self.pos_embedding == "learned":
            h = h + self.enc_pos[None, :S]
        else:
            pos = torch.arange(S, device=src.device)
            bias = self._rel_bias(self.enc_rel_bias, pos, pos, True)
        if train and self.drop > 0.0:
            h = F.dropout(h, self.drop)
        flash = self.uses_flash(src.device.type)
        for blk in self.enc_blocks():
            h = blk(h, mask, train, bias, flash, generator)
        return self.enc_ln(h), mask

    def memory_kv(self, memory):
        """Each decoder layer's cross-attention K/V, projected once."""
        return [blk.cross.memory_kv(memory) for blk in self.dec_blocks()]

    def decode_tgt(self, tgt, mem_kv, mem_mask, train: bool = False,
                   cache: Optional[dict] = None, offset=None,
                   generator=None):
        """The target stream through the decoder against the memory's K/V.
        With ``cache`` (:func:`init_seq2seq_cache`) it decodes at
        ``offset`` (an int, default 0, or a (B,) tensor of per-row
        positions) and writes the cache in place; the caller keeps the
        position.  Returns (logits, h)."""
        B, T = tgt.shape
        if T > self.max_len:
            raise ValueError(f"target length {T} > max_len {self.max_len}")
        dev = tgt.device
        h = self.word_embed[tgt]
        decode = cache is not None
        if decode:
            offset = 0 if offset is None else offset
            if isinstance(offset, torch.Tensor) and offset.ndim == 1:
                q_pos = offset.long()[:, None] + torch.arange(T, device=dev)
            else:
                offset = int(offset)
                q_pos = offset + torch.arange(T, device=dev)
        else:
            q_pos = torch.arange(T, device=dev)
        bias = None
        if self.pos_embedding == "learned":
            h = h + self.dec_pos[q_pos]
        else:
            k_pos = torch.arange(self.max_len if decode else T, device=dev)
            bias = self._rel_bias(self.dec_rel_bias, q_pos, k_pos, False)
        if train and self.drop > 0.0:
            h = F.dropout(h, self.drop)
        flash = not decode and self.uses_flash(tgt.device.type)
        for i, (blk, (mk, mv)) in enumerate(zip(self.dec_blocks(), mem_kv)):
            layer = cache[f"dec_block_{i}"]["self_attn"] if decode else None
            h = blk(h, mk, mv, mem_mask, train, layer, offset, bias, flash,
                    generator)
        h = self.dec_ln(h)
        h_out = h * self.logit_scale if self.logit_scale != 1.0 else h
        head = self.word_embed if self.tied_decoder else self.lm_head
        return F.linear(h_out, head), h

    def forward(self, src, tgt, train: bool = False, generator=None):
        memory, mem_mask = self.encode(src, train, generator)
        return self.decode_tgt(tgt, self.memory_kv(memory), mem_mask, train,
                               generator=generator)


def init_seq2seq_cache(model: TransformerSeq2Seq, bs: int) -> dict:
    """Zeroed decoder self-attention KV cache in the model's dtype and
    device, shaped like the flax cache tree: ``{"dec_block_{i}":
    {"self_attn": {"k", "v"}}}`` of (bs, max_len, H, hd)."""
    w = model.word_embed
    shape = (bs, model.max_len, model.n_heads, model.d_model // model.n_heads)
    return {f"dec_block_{i}": {"self_attn": {
        n: torch.zeros(shape, dtype=w.dtype, device=w.device)
        for n in ("k", "v")}} for i in range(model.dec_layers)}


@torch.no_grad()
def seq2seq_generate(model: TransformerSeq2Seq, src, n: int, bos: int,
                     k: int = 1, temperature: float = 1.0, generator=None):
    """Cached encoder-decoder continuation: one encoder pass and one
    projection of the memory's K/V, then ``n`` target tokens, each sampled
    from the top ``k`` (k=1: greedy) and fed back through one cached
    decode step.  ``src`` (B, S) ids on the model's device (or anything
    ``torch.as_tensor`` takes); ``generator`` (a CPU ``torch.Generator``)
    draws the samples.  Returns (B, n) int64 on the model's device."""
    dev = model.word_embed.device
    src = torch.as_tensor(np.asarray(src) if not torch.is_tensor(src)
                          else src, device=dev).long()
    B = src.shape[0]
    if n + 1 > model.max_len:
        raise ValueError(f"n + bos ({n + 1}) exceeds max_len "
                         f"{model.max_len}")
    model.eval()
    memory, mem_mask = model.encode(src)
    mem_kv = model.memory_kv(memory)
    cache = init_seq2seq_cache(model, B)
    tok = torch.full((B, 1), bos, dtype=torch.long, device=dev)
    out = []
    for off in range(n):
        logits, _ = model.decode_tgt(tok, mem_kv, mem_mask, cache=cache,
                                     offset=off)
        last = logits[:, -1].float() / max(temperature, 1e-6)
        if k == 1:
            nxt = last.argmax(-1)
        else:
            vals, idxs = torch.topk(last, k)
            cdf = torch.softmax(vals, -1).cumsum(-1)
            u = torch.rand(B, 1, generator=generator).to(dev)
            choice = (cdf < u).sum(-1).clamp(max=k - 1)
            nxt = idxs.gather(1, choice[:, None])[:, 0]
        out.append(nxt)
        tok = nxt[:, None]
    return torch.stack(out, 1)


def seq2seq_collate(pairs, pad: int, bos: int, eos: int,
                    max_src: Optional[int] = None,
                    max_tgt: Optional[int] = None):
    """Batch (source_ids, target_ids) pairs into the Learner's
    ((src, tgt_in), tgt_out) layout: right-padded source, teacher-forced
    target shifted by one ([bos] + tgt vs tgt + [eos]), pad everywhere
    else.  Returns (src, tgt_in, tgt_out) int32 numpy arrays."""
    S = max_src or max(len(s) for s, _ in pairs)
    T = max_tgt + 1 if max_tgt else max(len(t) for _, t in pairs) + 1
    src = np.full((len(pairs), S), pad, np.int32)
    tin = np.full((len(pairs), T), pad, np.int32)
    tout = np.full((len(pairs), T), pad, np.int32)
    for i, (s, t) in enumerate(pairs):
        s, t = list(s)[:S], list(t)[:T - 1]
        src[i, :len(s)] = s
        tin[i, 0], tin[i, 1:len(t) + 1] = bos, t
        tout[i, :len(t)], tout[i, len(t)] = t, eos
    return src, tin, tout


class Seq2SeqCrossEntropyLoss:
    """Token-masked sequence cross entropy: pad target positions
    (``target == pad``) carry no loss, and the Learner's per-row mask of a
    short batch multiplies in."""

    def __init__(self, pad: int):
        self.pad = pad

    def __call__(self, outputs, target, mask=None):
        logits = outputs[0] if isinstance(outputs, tuple) else outputs
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, target[..., None].long())[..., 0]
        w = (target != self.pad).to(nll.dtype)
        if mask is not None:
            w = w * mask[:, None].to(nll.dtype)
        return (nll * w).sum() / w.sum().clamp(min=1.0)
