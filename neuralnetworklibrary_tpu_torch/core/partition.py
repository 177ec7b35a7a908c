"""Layer groups, normalization-layer flags and freeze masks over a torch
module's parameters.

Counterpart of ``neuralnetworklibrary_tpu/core/partition.py``.  Each
parameter (path = its dotted name split on ".") gets a layer-group index
by the longest matching prefix, an ``is_bn`` flag and an ``in_head`` flag;
trainability is a function of ``frozen`` and ``bn_frozen`` over the
head and bn flags.

``is_bn`` marks the parameters of BatchNorm modules, the ones that keep
running statistics: the JAX package detects them by their ``batch_stats``
collection (``detect_bn_paths``), which LayerNorm and RMSNorm do not have.
A transformer therefore has no bn parameters, and decoupled weight decay
reaches every trainable leaf, norm scales and biases included; the image
models' ``nn.layers.BatchNorm`` is a ``_BatchNorm``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from neuralnetworklibrary_tpu_torch.core.pytree import Path, param_paths

PathPrefix = tuple[str, ...]


def _normalize_prefix(p) -> PathPrefix:
    if isinstance(p, str):
        return tuple(p.replace("/", ".").split(".")) if p else ()
    return tuple(p)


def _starts_with(path: Path, prefix: PathPrefix) -> bool:
    return path[: len(prefix)] == prefix


@dataclass(frozen=True)
class Partition:
    """Immutable description of a model's parameter partitioning."""

    paths: tuple[Path, ...]          # parameter paths, named_parameters order
    group_idx: tuple[int, ...]       # layer-group index per parameter
    is_bn: tuple[bool, ...]          # BatchNorm parameter?
    in_head: tuple[bool, ...]        # under the model's head prefixes?
    n_groups: int

    def trainable_mask(self, frozen: bool = False,
                       bn_frozen: str | None = None) -> tuple[bool, ...]:
        """Trainability per parameter under the reference's freezing rules.

        ``frozen=True`` -> only head parameters train (Learner.freeze,
        :237-241).  ``bn_frozen='all'`` -> no bn parameter trains
        (Learner.bn_freeze, :248-264); ``'non_head'`` -> bn parameters
        train only in the head.
        """
        if bn_frozen not in (None, "all", "non_head"):
            raise ValueError(f"bn_frozen must be None, 'all', or "
                             f"'non_head', got {bn_frozen!r}")
        out = []
        for bn, head in zip(self.is_bn, self.in_head):
            t = not (frozen and not head)
            if bn and (bn_frozen == "all"
                       or (bn_frozen == "non_head" and not head)):
                t = False
            out.append(t)
        return tuple(out)


def detect_bn_paths(model: torch.nn.Module) -> set[Path]:
    """Parameters of BatchNorm modules (the modules with running
    statistics)."""
    out = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            for pname, _ in mod.named_parameters(recurse=False):
                out.add(tuple(f"{mname}.{pname}".lstrip(".").split(".")))
    return out


def build_partition(
    model: torch.nn.Module,
    layer_groups: Sequence[Sequence[PathPrefix | str]] | None = None,
    head_prefixes: Sequence[PathPrefix | str] = ("head",),
) -> Partition:
    """Partition ``model``'s parameters (``build_partition`` :100).

    ``layer_groups`` is a list of groups, each a list of path prefixes
    (strings may use "." or "/" separators).  Every parameter must be
    covered; the longest matching prefix wins.  ``None`` is one group
    holding the whole model.
    """
    paths = tuple(param_paths(model))
    if layer_groups is None:
        layer_groups = [[()]]
    norm_groups = [[_normalize_prefix(p) for p in g] for g in layer_groups]
    heads = [_normalize_prefix(p) for p in head_prefixes]
    group_idx = []
    for path in paths:
        best = None  # (prefix length, group)
        for g, prefixes in enumerate(norm_groups):
            for pref in prefixes:
                if _starts_with(path, pref) and (best is None
                                                 or len(pref) > best[0]):
                    best = (len(pref), g)
        if best is None:
            raise ValueError(f"parameter {'.'.join(path)} is not covered by "
                             f"any layer group")
        group_idx.append(best[1])
    bn_paths = detect_bn_paths(model)
    return Partition(
        paths=paths,
        group_idx=tuple(group_idx),
        is_bn=tuple(p in bn_paths for p in paths),
        in_head=tuple(any(_starts_with(p, h) for h in heads) for p in paths),
        n_groups=len(norm_groups),
    )
