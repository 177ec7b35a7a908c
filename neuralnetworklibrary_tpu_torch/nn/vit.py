"""Vision Transformer classifier (ViT, Dosovitskiy et al. 2021).

Counterpart of ``neuralnetworklibrary_tpu/nn/vit.py``: a stride-P patch
conv, a [CLS] token and learned position embeddings, L bidirectional
pre-norm blocks (``nn.transformer.TransformerBlock(causal=False)``), a
final LayerNorm and a head on the CLS token (or on the mean of the tokens
with ``pool="mean"``).  Module names are the flax names (``patch_embed``,
``cls``, ``pos_embed``, ``block_{i}``, ``ln_f``, ``head``).

Images come in NHWC, as the Learner's input pipeline hands them over
(``ops.augment.normalize_batch``).  The patch tokens are taken in the JAX
model's row-major (h, w) order: the NCHW conv output's
``flatten(2).transpose(1, 2)``.

``flash_attention=True`` sends attention through ``ops.flash_attention``
(bidirectional, no bias, no key mask: the CUDA kernels K1-K3 on the card,
the plain version on the CPU) at the model's own token count (197 at 224
px and patch 16); False takes the einsum path, as in JAX.  LoRA
(``lora_rank > 0``) is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.nn.layers import conv2d, lecun_normal_
from neuralnetworklibrary_tpu_torch.nn.transformer import (
    TransformerBlock,
    resolve_device,
)


class ViT(nn.Module):
    """ViT classifier.  Two layer groups for the Learner (backbone, head),
    so ``freeze()`` fine-tunes the head alone.  ``device`` defaults to
    cuda; convert the dtype with autocast (the Learner's
    ``compute_dtype``)."""

    head_prefixes = ("head",)

    def __init__(self, num_classes: int, image_size: int = 224,
                 patch: int = 16, d_model: int = 384, n_heads: int = 6,
                 n_layers: int = 12, d_ff: int = 0, drop: float = 0.0,
                 pool: str = "cls", norm_eps: float = 1e-6,
                 exact_gelu: bool = False, flash_attention: bool = False,
                 lora_rank: int = 0, in_channels: int = 3, device=None):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        if lora_rank > 0:
            raise NotImplementedError("ViT(lora_rank > 0): nn/lora.py is not "
                                      "ported yet (ROADMAP Queue 1)")
        if image_size % patch:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch}")
        dev = resolve_device(device)
        self.num_classes, self.image_size, self.patch = (num_classes,
                                                         image_size, patch)
        self.d_model, self.n_heads, self.n_layers = d_model, n_heads, n_layers
        self.drop, self.pool = drop, pool
        self.flash_attention = flash_attention
        n_tokens = (image_size // patch) ** 2 + 1
        self.patch_embed = conv2d(in_channels, d_model, patch, patch,
                                  init=lecun_normal_, device=dev)
        self.patch_embed.to(memory_format=torch.channels_last)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model, device=dev))
        self.pos_embed = nn.Parameter(
            torch.empty(n_tokens, d_model, device=dev).normal_(0, 0.02))
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, d_ff=d_ff or 4 * d_model, drop=drop,
                norm_eps=norm_eps, exact_gelu=exact_gelu, causal=False,
                device=dev))
        self.ln_f = nn.LayerNorm(d_model, eps=norm_eps, device=dev)
        self.head = nn.Linear(d_model, num_classes, device=dev)
        lecun_normal_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    @property
    def layer_group_prefixes(self):
        blocks = tuple(f"block_{i}" for i in range(self.n_layers))
        return (("patch_embed", "cls", "pos_embed", "ln_f") + blocks,
                ("head",))

    def forward(self, x, train: bool = False, generator=None):
        """x (B, H, W, C) float images -> (B, num_classes) logits.
        ``train=True`` applies dropout; ``generator`` (a CPU
        ``torch.Generator``) seeds the flash kernels' dropout."""
        B, H, W, _ = x.shape
        P = self.patch
        if H % P or W % P:
            raise ValueError(f"image {H}x{W} not divisible by patch {P}")
        h = self.patch_embed(x.permute(0, 3, 1, 2))       # (B, D, H/P, W/P)
        h = h.flatten(2).transpose(1, 2)                   # (B, N-1, D)
        h = torch.cat([self.cls.expand(B, 1, -1).to(h.dtype), h], 1)
        h = h + self.pos_embed[None]
        if train and self.drop > 0.0:
            h = F.dropout(h, self.drop)
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h, train=train,
                                            flash=self.flash_attention,
                                            generator=generator)
        h = self.ln_f(h)
        feat = h[:, 0] if self.pool == "cls" else h.mean(dim=1)
        return self.head(feat)

    @classmethod
    def from_dataobj(cls, data, **kw):
        """Build from a data object: ``image_size`` from ``data.sz``,
        ``num_classes`` from ``data.classes`` (else the keyword), as in
        JAX."""
        sz = getattr(data, "sz", kw.pop("image_size", 224))
        return cls(num_classes=len(getattr(data, "classes", [])) or
                   kw.pop("num_classes"), image_size=sz, **kw)
