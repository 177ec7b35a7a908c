"""Building-block layers.

Counterpart of ``neuralnetworklibrary_tpu/nn/layers.py`` (General/Layers.py
of the reference).  Module attribute names are the flax names (``lin``,
``conv``, ``bn``, ``pre_bn``, ``lins_{i}``, ``final_lin``, ``emb``,
``embedding``), so ``utils.jax_params.load_jax_params`` carries weights
across by renaming.

Conventions, as in the JAX package:

- a module takes ``train`` (dropout on) and ``bn_train`` (None: follow
  ``train``): BatchNorm normalizes by the batch and updates its running
  statistics exactly when ``bn_train`` (or else ``train``) is true.  The
  torch ``training`` flag is not read, so ``model.train()`` changes
  nothing; this is what lets ``Learner.bn_freeze`` keep a BatchNorm on
  its running statistics in a train step.
- images are NCHW tensors, kept in ``channels_last`` memory by the conv
  nets so that cuDNN sees NHWC without a copy; the models that take
  NHWC images (``ImageClassificationNet``, ``ViT``) permute once.
- linear and conv kernels draw flax's ``he_normal`` (a normal truncated at
  two standard deviations, its std corrected for the truncation) with zero
  bias; the same distribution as the JAX package, not the same bits.
- random masks of the models that take a ``generator`` (the Learner's
  seeded CPU generator) come from a generator on the input's device seeded
  by one draw from it (:func:`device_generator`); ``F.dropout`` draws
  from torch's default generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

# std of a standard normal truncated to (-2, 2): flax's variance_scaling
# divides by it so the truncated draw keeps the asked variance
_TRUNC_STD = 0.87962566103423978


def trunc_normal_init(std: float = 0.01):
    """torch ``normal_().fmod_(2).mul_(std)`` (Layers.py:60): an in-place
    init function of a tensor, standard normal folded into (-2, 2) by
    mod 2, then scaled."""

    def init(t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return t.normal_().fmod_(2.0).mul_(std)

    return init


def _variance_scaling_(t: torch.Tensor, scale: float) -> torch.Tensor:
    fan_in = nn.init._calculate_fan_in_and_fan_out(t)[0]
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


def he_normal_(t: torch.Tensor) -> torch.Tensor:
    """flax ``he_normal`` (kaiming normal, fan in, truncated), in place."""
    return _variance_scaling_(t, 2.0)


def lecun_normal_(t: torch.Tensor) -> torch.Tensor:
    """flax ``lecun_normal``, the default of ``nn.Dense`` and ``nn.Conv``,
    in place."""
    return _variance_scaling_(t, 1.0)


def linear(n_in: int, n_out: int, init=he_normal_, device=None) -> nn.Linear:
    """``nn.Linear`` with a flax init and zero bias."""
    lin = nn.Linear(n_in, n_out, device=device)
    init(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


def conv2d(n_in: int, n_out: int, kernel: int, stride: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = True,
           init=he_normal_, device=None) -> nn.Conv2d:
    """``nn.Conv2d`` with explicit (p, p) padding, a flax init and zero
    bias."""
    conv = nn.Conv2d(n_in, n_out, kernel, stride, padding, groups=groups,
                     bias=bias, device=device)
    init(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def keep_mask(shape, rate, like, generator=None) -> torch.Tensor:
    """A 0/1 mask of ``shape`` in like's dtype and device, 1 with
    probability 1 - rate, drawn from ``generator``."""
    return like.new_empty(shape).bernoulli_(1.0 - rate, generator=generator)


def device_generator(generator, device) -> torch.Generator:
    """A generator on ``device`` seeded by one int drawn from
    ``generator`` (a CPU generator, or None for torch's default): a CPU
    generator cannot draw masks for CUDA tensors."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def use_running_average(train: bool, bn_train: Optional[bool]) -> bool:
    """flax's ``use_running_average = not (train if bn_train is None else
    bn_train)``."""
    return not (train if bn_train is None else bn_train)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(bs, ...) -> (bs, n) (class Flatten, Layers.py:20)."""
    return x.reshape(x.shape[0], -1)


def flatten1d(x: torch.Tensor) -> torch.Tensor:
    """(bs, 1) -> (bs,) (class Flatten1d, Layers.py:25)."""
    return x.reshape(-1)


def sigmoidal_range(x: torch.Tensor, output_range) -> torch.Tensor:
    """Squash into [MIN, MAX] by a scaled sigmoid (Layers.py:150-152)."""
    lo, hi = float(output_range[0]), float(output_range[1])
    return lo + (hi - lo) * torch.sigmoid(x)


class BatchNorm(_BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of an
    (N, C) or (N, C, H, W) tensor.

    With batch statistics it normalizes by the biased batch variance, as
    torch does, but it also stores the biased variance: running <- 0.9 x
    running + 0.1 x batch for the mean and the variance alike.  (Torch's
    own BatchNorm stores the unbiased variance.)  The buffers stay float32
    under autocast.  It subclasses ``_BatchNorm`` so that
    ``core.partition`` flags its parameters as bn parameters.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None):
        super().__init__(num_features, eps, momentum, affine=True,
                         track_running_stats=True, device=device)

    def _check_input_dim(self, x):
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm takes (N, C) or (N, C, H, W), got "
                             f"{x.dim()} dims")

    def forward(self, x, use_running_average: bool = True):
        self._check_input_dim(x)
        if use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # torch updates the mean buffer as flax does; the variance goes to
        # a zero scratch, which becomes momentum x the unbiased variance,
        # and is carried over to the biased one
        n = x.numel() // x.shape[1]
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=(n - 1) / n)
        return y


class LinearBlock(nn.Module):
    """dropout -> linear -> relu -> bn (class Linear, Layers.py:30-41)."""

    def __init__(self, n_in: int, nout: int, bn: bool = True,
                 drop: float = 0.0, device=None):
        super().__init__()
        self.drop = drop
        self.lin = linear(n_in, nout, device=device)
        self.bn = BatchNorm(nout, device=device) if bn else None

    def forward(self, x, train: bool = False, bn_train=None):
        if self.drop and train:
            x = F.dropout(x, self.drop)
        x = F.relu(self.lin(x))
        if self.bn is not None:
            x = self.bn(x, use_running_average(train, bn_train))
        return x


class ConvBlock(nn.Module):
    """dropout -> conv -> relu -> bn over NCHW (class Conv2d,
    Layers.py:43-54)."""

    def __init__(self, n_in: int, nout: int, ks: int = 3, stride: int = 1,
                 pad: int = 1, bn: bool = True, drop: float = 0.0,
                 device=None):
        super().__init__()
        self.drop = drop
        self.conv = conv2d(n_in, nout, ks, stride, pad, device=device)
        self.bn = BatchNorm(nout, device=device) if bn else None

    def forward(self, x, train: bool = False, bn_train=None):
        if self.drop and train:
            x = F.dropout(x, self.drop)
        x = F.relu(self.conv(x))
        if self.bn is not None:
            x = self.bn(x, use_running_average(train, bn_train))
        return x


class Embedding(nn.Module):
    """Embedding table (``get_embedding``, Layers.py:56-61), initialised
    by :func:`trunc_normal_init` at ``std``.

    ``max_norm`` rescales each gathered row to norm at most ``max_norm``
    as a function of the table, as the JAX module does, so the gradient
    flows through the norm.  (torch's ``nn.Embedding(max_norm=)``
    renormalises the table's rows in place instead, with another
    gradient.)"""

    def __init__(self, num_embeddings: int, features: int, std: float = 0.01,
                 max_norm: Optional[float] = None, device=None):
        super().__init__()
        self.max_norm = max_norm
        self.embedding = nn.Parameter(trunc_normal_init(std)(
            torch.empty(num_embeddings, features, device=device)))

    def forward(self, idx):
        rows = self.embedding[idx]
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
            rows = rows * torch.clamp(
                self.max_norm / torch.clamp(norms, min=1e-12), max=1.0)
        return rows


class EmbeddingDrop(nn.Module):
    """:class:`Embedding` with per-sample whole-vector dropout (class
    EmbeddingDrop, Layers.py:63-76): in training a (bs,) mask, 1 with
    probability 1 - drop, scales each sample's whole vector by 1/(1 -
    drop)."""

    def __init__(self, num_embeddings: int, features: int, drop: float = 0.0,
                 std: float = 0.01, max_norm: Optional[float] = None,
                 device=None):
        super().__init__()
        self.drop = drop
        self.emb = Embedding(num_embeddings, features, std, max_norm, device)

    def forward(self, idx, train: bool = False, generator=None):
        emb = self.emb(idx)
        if self.drop and train:
            keep = keep_mask((emb.shape[0], 1), self.drop, emb, generator)
            emb = emb * keep / (1.0 - self.drop)
        return emb


def adaptive_concat_pool2d(x: torch.Tensor) -> torch.Tensor:
    """Global max-pool and avg-pool of an NCHW map, concatenated max first:
    (bs, 2C) (class AdaptiveConcatPool2d, Layers.py:78-87)."""
    return torch.cat([x.amax(dim=(2, 3)), x.mean(dim=(2, 3))], dim=1)


class FullyConnectedNet(nn.Module):
    """Multi-layer fully connected head (class FullyConnectedNet,
    Layers.py:89-154).

    layer_sizes = [n_in, h1, ..., n_out]; relu and optional bn after every
    layer but the last; per-layer dropout before each linear; optional
    pre-bn on the input; final activation None, 'softmax' or 'sigmoidal'
    (with ``output_range``).
    """

    def __init__(self, layer_sizes: Sequence[int],
                 drops: Optional[Sequence[float]] = None,
                 final_activ: Optional[str] = None, output_range=None,
                 bn: bool = True, pre_bn: bool = True, device=None):
        super().__init__()
        N = len(layer_sizes) - 1
        self.drops = list(drops) if drops is not None else [0.0] * N
        self.final_activ, self.output_range = final_activ, output_range
        self.n_hidden = N - 1
        self.pre_bn = (BatchNorm(layer_sizes[0], device=device) if pre_bn
                       else None)
        for i in range(N - 1):
            self.add_module(f"lins_{i}", LinearBlock(
                layer_sizes[i], layer_sizes[i + 1], bn=bn,
                drop=self.drops[i], device=device))
        self.final_lin = linear(layer_sizes[N - 1], layer_sizes[N],
                                device=device)

    def forward(self, x, train: bool = False, bn_train=None):
        if self.pre_bn is not None:
            x = self.pre_bn(x, use_running_average(train, bn_train))
        for i in range(self.n_hidden):
            x = getattr(self, f"lins_{i}")(x, train, bn_train)
        last_drop = self.drops[self.n_hidden]
        if last_drop and train:
            x = F.dropout(x, last_drop)
        x = self.final_lin(x)
        if self.final_activ == "softmax":
            x = torch.softmax(x, dim=1)
        elif self.final_activ == "sigmoidal":
            x = sigmoidal_range(x, self.output_range)
        return x
