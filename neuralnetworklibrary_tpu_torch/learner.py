"""The Learner: training and evaluation bound to {data, model, optimizer,
loss}, on one device.

Counterpart of ``neuralnetworklibrary_tpu/learner.py`` (the reference's
General/Learner.py).  What carries over unchanged:

- per-minibatch lr / momentum / beta schedules (``fit``, ``fit_cycles``,
  ``fit_one_cycle``, ``train_gen_sched``, ``find_lr``) with per-layer-group
  learning rates and weight decay;
- the short-batch rule: the loader pads the last batch to ``bs`` rows with
  a mask, losses take the masked mean, and the lr of that step is scaled
  by ``n_valid / bs`` (``_hyper_row``, Learner.py:503-505);
- the train-loss EMA (0.98 decay, debiased when read), kept on the device;
- ``freeze`` / ``unfreeze`` by layer group, each resetting the optimizer
  state as the reference does;
- ``compute_dtype="bfloat16"``: parameters, optimizer state and the loss
  stay float32;
- a model's carried state (the AWD-LSTM encoder's (h, c), JAX's ``carry``
  collection) goes on from batch to batch in training and in evaluation
  alike, and nothing resets it between epochs.  Here it lives in the
  model's buffers, so ``save``/``load`` keep it with the weights;
- an ``input_pipeline(generator, xs, train)`` runs on the device tensors
  before the forward of every train, eval and predict batch (JAX's
  ``input_pipeline(key, xs, train)``), with a ``torch.Generator`` on the
  Learner's device seeded from ``seed`` in place of the key;
- ``bn_freeze`` / ``bn_unfreeze`` and ``set_trainable``; a model whose
  forward takes ``bn_frozen`` is called with it, so frozen BatchNorms stay
  on their running statistics in training and leave them unchanged;
- ``evaluate('val')`` gives the accuracy of 'cat', 'single_label' and
  'multi_label' targets, batch metrics, and end metrics (``'auc'`` or an
  object with ``is_end_metric``) over the whole set, each batch reduced on
  the host by the metric's ``prepare``; ``predict`` runs over a whole
  loader.

What differs: PyTorch runs eagerly, so one train step is forward,
``backward`` and :meth:`Optimizer.apply` in place, with no jit.  Frozen
parameters get ``requires_grad=False``.  Mixed precision is
``torch.autocast``: matrix products run in bf16 while LayerNorm, softmax
and the residual stream stay float32 (the JAX Learner casts the whole
forward to bf16).  Batches reach the device by a pinned-memory,
non-blocking copy, one batch ahead of the step, in place of the JAX
package's mesh sharding and device prefetch.  uint8 arrays (images)
cross as uint8; other integer arrays become int64.

Not ported yet, each raising ``NotImplementedError``: mesh / ZeRO / FSDP,
``grad_accum``, ``mixup``, ``distill``, fused epochs, SWA and ``find_lr``
plotting (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from neuralnetworklibrary_tpu_torch.core import metrics as M
from neuralnetworklibrary_tpu_torch.core.optim import Optimizer
from neuralnetworklibrary_tpu_torch.core.partition import build_partition
from neuralnetworklibrary_tpu_torch.core.pytree import (
    broadcast_to_groups,
    param_paths,
)
from neuralnetworklibrary_tpu_torch.core.schedules import (
    cycles_sched,
    get_sched,
    one_cycle_scheds,
)
from neuralnetworklibrary_tpu_torch.data.loader import Batch
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device
from neuralnetworklibrary_tpu_torch.utils import tracing

_EMA_DECAY = 0.98  # moving_avg_loss decay (Learner.py:610)
_TODO = "is not ported yet (ROADMAP Queue 1)"


def _correct_foldername(p: str) -> str:
    return p if p.endswith("/") else p + "/"


def _to_f32(out):
    """Model outputs back to float32 (the JAX ``_cast_f32``)."""
    if isinstance(out, tuple):
        return tuple(_to_f32(o) for o in out)
    if torch.is_tensor(out) and out.is_floating_point():
        return out.float()
    return out


class Learner:
    """Binds a data object, model, optimizer and loss on one device.

    PATH: working directory; checkpoints go to ``PATH/models/``.
    data: has ``.target_type``, ``.bs``, ``.train_dl`` and ``.val_dl``
        whose loaders yield :class:`~..data.loader.Batch`.
    model: an ``nn.Module`` called as ``model(*xs, train=bool)`` (and
        ``generator=`` when its forward takes one), with optional
        ``layer_group_prefixes`` and ``head_prefixes``.  It is moved to
        ``device``.
    optimizer: an :class:`Optimizer` or a name from ``core.optim.opt_dict``.
    loss_func: ``loss(y_pred, y, mask=None)`` or 'default' (by target type).
    seed: seeds the CPU ``torch.Generator`` handed to the model, from which
        it draws the flash kernels' dropout seeds and the seeds of the
        device generators that draw the AWD-LSTM's dropout masks; and the
        device generator handed to ``input_pipeline``.
    compute_dtype: None or 'bfloat16' (autocast).
    device: defaults to cuda; without a card pass ``device='cpu'``.
    input_pipeline: None or ``pipeline(generator, xs, train) -> xs`` on the
        batch's device tensors (e.g. ``ops.augment.augment_batch`` for
        training and ``normalize_batch`` otherwise).
    """

    def __init__(self, PATH: str, data, model, optimizer="default",
                 loss_func="default", use_moving_avg: bool = True,
                 seed: int = 0, compute_dtype=None, device=None, mesh=None,
                 input_pipeline=None, zero_sharding: bool = False,
                 fsdp_sharding: bool = False, grad_accum: int = 1,
                 mixup: float = 0.0, distill=None):
        for name, asked in (("mesh", mesh is not None),
                            ("zero_sharding", zero_sharding),
                            ("fsdp_sharding", fsdp_sharding),
                            ("grad_accum", grad_accum != 1),
                            ("mixup", mixup != 0.0),
                            ("distill", distill is not None)):
            if asked:
                raise NotImplementedError(f"Learner({name}=...) {_TODO}")
        self.device = resolve_device(device)
        self.PATH = _correct_foldername(PATH)
        os.makedirs(self.PATH + "models", exist_ok=True)
        self.data, self.model = data, model.to(self.device)
        self.target_type = data.target_type
        self.use_moving_avg = use_moving_avg
        if loss_func == "default":
            if self.target_type not in M.loss_func_dict:
                raise NotImplementedError(
                    f"no default loss for target_type "
                    f"{self.target_type!r} yet; pass loss_func=")
            loss_func = M.loss_func_dict[self.target_type]
        self.loss_func = loss_func
        self.optimizer = (Optimizer(optimizer) if isinstance(optimizer, str)
                          else optimizer)
        self.set_compute_dtype(compute_dtype)
        self.generator = torch.Generator().manual_seed(seed)
        self.input_pipeline = input_pipeline
        self.pipeline_generator = torch.Generator(self.device).manual_seed(
            seed)
        self.params = param_paths(self.model)
        self.partition = build_partition(
            self.model, getattr(model, "layer_group_prefixes", None),
            getattr(model, "head_prefixes", ("head",)))
        self.opt_state = self.optimizer.init(self.params)
        self.frozen = False
        self.bn_frozen: Optional[str] = None
        self._trainable_override: Optional[tuple] = None
        self._grad_mask = None
        self.loss_sched: list = []
        self.lr_sched: list = []
        self.mom_sched: list = []
        self.betas_sched: list = []
        self.moving_avg_loss = 0.0
        self._ema = torch.zeros((), device=self.device)
        self._global_step = 0
        fwd = inspect.signature(self.model.forward).parameters
        self._accepts_generator = "generator" in fwd
        self._accepts_bn_frozen = "bn_frozen" in fwd
        try:
            sig = inspect.signature(self.loss_func).parameters
            self._loss_accepts_mask = "mask" in sig or len(sig) >= 3
        except (TypeError, ValueError):
            self._loss_accepts_mask = True

    @property
    def n_groups(self) -> int:
        return self.partition.n_groups

    # ------------------------------------------------------ save / load

    def _ckpt_path(self, filename: str) -> str:
        return self.PATH + "models/" + filename + ".pt"

    def save(self, filename: str, save_optimizer: bool = False):
        """``torch.save`` the model's state dict (and the optimizer state)
        to ``PATH/models/<filename>.pt`` (Learner.py:119-133)."""
        obj = {"model": self.model.state_dict()}
        if save_optimizer:
            obj["opt_state"] = self.opt_state
        torch.save(obj, self._ckpt_path(filename))

    def load(self, filename: str, saved_optimizer: bool = False):
        """Restore a checkpoint written by :meth:`save` (Learner.py:135-153)."""
        path = self._ckpt_path(filename)
        if not os.path.isfile(path):
            print(f"no file found at '{path}'")
            return
        obj = torch.load(path, map_location=self.device)
        self.model.load_state_dict(obj["model"])
        if saved_optimizer and "opt_state" in obj:
            self.opt_state = obj["opt_state"]

    # ------------------------------------------------ freeze / unfreeze

    def freeze(self):
        """Train only the head layer group (Learner.py:237-241)."""
        if not any(self.partition.in_head):
            import warnings

            warnings.warn("freeze(): no parameter lies under the model's "
                          "head_prefixes; every parameter is now frozen")
        self.frozen = True
        self.opt_state = self.optimizer.init(self.params)

    def unfreeze(self):
        """Train every layer group (Learner.py:243-246)."""
        self.frozen = False
        self.opt_state = self.optimizer.init(self.params)

    def bn_freeze(self, freeze_type: str = "non_head"):
        """Freeze BatchNorm layers: their parameters stop training and
        their running statistics stop updating, everywhere ('all') or
        outside the head ('non_head') (Learner.py:248-264)."""
        if freeze_type not in ("all", "non_head"):
            raise ValueError("freeze_type must be 'all' or 'non_head'")
        self.bn_frozen = freeze_type
        self.opt_state = self.optimizer.init(self.params)

    def bn_unfreeze(self):
        self.bn_frozen = None
        self.opt_state = self.optimizer.init(self.params)

    def set_trainable(self, fn):
        """Train exactly the parameters whose path ``fn(path) -> bool``
        selects, in place of the freeze / bn_freeze masks;
        ``set_trainable(None)`` restores them.  Resets the optimizer
        state."""
        if fn is None:
            self._trainable_override = None
        else:
            mask = tuple(bool(fn(p)) for p in self.partition.paths)
            if not any(mask):
                raise ValueError(
                    "set_trainable: the predicate selects no parameter")
            self._trainable_override = mask
        self.opt_state = self.optimizer.init(self.params)

    def _trainable(self) -> tuple:
        if self._trainable_override is not None:
            return self._trainable_override
        return self.partition.trainable_mask(self.frozen, self.bn_frozen)

    # ------------------------------------------------ mixed precision

    def set_compute_dtype(self, dtype):
        """Mixed precision on (``'bfloat16'``) or off (None)."""
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or 'bfloat16', "
                             f"got {dtype}")
        self.compute_dtype = dtype

    def _autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # ------------------------------------------------ the step

    def _to_device(self, batch: Batch):
        """(xs, y, mask) on the device: pinned host copies sent without
        blocking the host; uint8 arrays (images) stay uint8, other integer
        arrays become int64.  A tuple target (detection's (bboxes, cats))
        crosses element by element."""
        def put(a):
            if isinstance(a, tuple):
                return tuple(put(x) for x in a)
            t = _as_batch_tensor(torch.from_numpy(np.ascontiguousarray(a)))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with tracing.span("learner.h2d"):
            return (tuple(put(x) for x in batch.xs), put(batch.y),
                    put(batch.mask))

    def _device_batches(self, dl):
        """Yield (batch, device tensors), copying batch k+1 before batch k
        is handed out."""
        ahead = None
        for batch in dl:
            cur = (batch, self._to_device(batch))
            if ahead is not None:
                yield ahead
            ahead = cur
        if ahead is not None:
            yield ahead

    def _model_kwargs(self, train: bool) -> dict:
        kw = {"train": train}
        if self._accepts_generator:
            kw["generator"] = self.generator
        if self._accepts_bn_frozen:
            kw["bn_frozen"] = self.bn_frozen
        return kw

    def set_input_pipeline(self, pipeline):
        """Replace the device input pipeline."""
        self.input_pipeline = pipeline

    def _pipeline(self, xs, train: bool):
        if self.input_pipeline is None:
            return xs
        return tuple(self.input_pipeline(self.pipeline_generator, xs, train))

    def _apply_loss(self, y_pred, y, mask):
        if self._loss_accepts_mask:
            return self.loss_func(y_pred, y, mask)
        return self.loss_func(y_pred, y)

    def _hyper_row(self, lr_row, n_valid, mom=None, betas=None):
        """Per-batch hyperparameters with the short-batch lr rescale
        (Learner.py:503-505); wd 0 and clip inf are no-ops."""
        NL = self.n_groups
        lr = np.asarray(broadcast_to_groups(lr_row, NL), np.float32)
        lr = lr * np.float32(n_valid / self.data.bs)
        wd = self.optimizer.wd
        wd = np.asarray(broadcast_to_groups(0.0 if wd is None else wd, NL),
                        np.float32)
        clip = np.float32(np.inf if self.optimizer.clip is None
                          else self.optimizer.clip)
        mom_v = np.float32(self.optimizer.momentum if mom is None else mom)
        b1, b2 = self.optimizer.betas if betas is None else betas
        return lr, wd, mom_v, np.float32(b1), np.float32(b2), clip

    def _set_grad_mask(self, trainable):
        if trainable != self._grad_mask:
            for path, t in zip(self.partition.paths, trainable):
                self.params[path].requires_grad_(t)
            self._grad_mask = trainable

    def _step(self, xs, y, mask, n_valid, lr_row, mom=None, betas=None):
        lr, wd, mom, b1, b2, clip = self._hyper_row(lr_row, n_valid, mom,
                                                    betas)
        trainable = self._trainable()
        self._set_grad_mask(trainable)
        for p in self.params.values():
            p.grad = None
        self._global_step += 1
        self.model.train()
        with tracing.span("learner.forward", device=True):
            xs = self._pipeline(xs, True)
            with self._autocast():
                y_pred = self.model(*xs, **self._model_kwargs(True))
        with tracing.span("learner.loss", device=True):
            loss = self._apply_loss(_to_f32(y_pred), y, mask)
        # the backward needs the float32 copies the loss took, not the
        # model's own outputs (an LM's (B, T, V) bf16 logits): free them
        del y_pred
        with tracing.span("learner.backward", device=True):
            loss.backward()
        grads = {path: p.grad for path, p in self.params.items()
                 if p.grad is not None}
        with tracing.span("learner.optimizer", device=True) as sp:
            if sp is not None:   # Adam's bytes follow the trained elements
                sp.data["elements"] = sum(g.numel() for g in grads.values())
            self.optimizer.apply(self.params, grads, self.opt_state,
                                 self.partition, trainable, lr, mom=mom,
                                 beta1=b1, beta2=b2, wd_groups=wd, clip=clip)
        loss = loss.detach()
        self._ema.mul_(_EMA_DECAY).add_(loss, alpha=1.0 - _EMA_DECAY)
        return loss

    def train1minibatch(self, batch: Batch, lr_batch, mom_batch=None,
                        betas_batch=None):
        """One optimizer update (Learner.py:490-516).  Returns the loss as
        a device scalar (``float()`` it only when you need to sync)."""
        with tracing.span("learner.step", step=self._global_step + 1):
            xs, y, mask = self._to_device(batch)
            return self._step(xs, y, mask, batch.n_valid, lr_batch,
                              mom_batch, betas_batch)

    # ------------------------------------------------ evaluate / predict

    @torch.no_grad()
    def evaluate(self, dataset_type: str, metrics: Sequence = ()):
        """Average loss over 'train' or 'val'; for 'val' also the accuracy
        of 'cat', 'single_label' and 'multi_label' targets and the values
        of ``metrics``, in the reference's shapes: 'train' -> float, 'val'
        -> [loss(, accuracy)(, metric values)] (Learner.py:395).

        A batch metric is ``m(y_pred, y, mask)``, averaged over the valid
        rows.  An end metric (a name in ``core.metrics.end_metrics``, or an
        object with ``is_end_metric``) is called once on the whole set's
        valid rows, which each batch hands to the host through the
        metric's ``prepare(y_pred, y)`` where it has one.  Batch metrics
        see the whole model output (detection's (anchors, reg, clas)); a
        'bbox' target counts no accuracy and takes no end metric
        (learner.py:815-851 of the JAX package)."""
        dl = self.data.train_dl if dataset_type == "train" else \
            self.data.val_dl
        if self.target_type == "bbox" and any(M.is_end_metric(m)
                                              for m in metrics):
            raise ValueError(
                "end metrics (whole-dataset metrics like 'auc') are not "
                "supported for tuple-target (bbox) learners; use batch "
                "metrics or compute_mAP/coco_pascal_eval instead")
        batch_ms = [m for m in metrics if not M.is_end_metric(m)]
        end_fns = [M.end_metrics[m]() if isinstance(m, str) else m
                   for m in metrics if M.is_end_metric(m)]
        end_acc = [([], []) for _ in end_fns]
        dev = self.device
        total = torch.zeros((), dtype=torch.float64, device=dev)
        count = torch.zeros((), dtype=torch.float64, device=dev)
        mvals = torch.zeros(len(batch_ms), dtype=torch.float64, device=dev)
        correct = torch.zeros((), dtype=torch.float64, device=dev)
        self.model.eval()
        for batch, (xs, y, mask) in self._device_batches(dl):
            y_pred = self._eval_forward(xs)
            n = mask.sum()
            total += self._apply_loss(y_pred, y, mask) * n
            count += n
            for i, m in enumerate(batch_ms):
                mvals[i] += m(y_pred, y, mask) * n
            logits = y_pred[0] if isinstance(y_pred, tuple) else y_pred
            if self.target_type in ("cat", "single_label"):
                correct += ((logits.argmax(1) == y) * mask).sum()
            elif self.target_type == "multi_label":
                hit = torch.round(torch.sigmoid(logits)) == y.to(logits.dtype)
                correct += (hit * mask[:, None]).sum()
            if end_fns:
                yp = logits[:batch.n_valid].cpu().numpy()
                yy = y[:batch.n_valid].cpu().numpy()
                for fn, (ps, ls) in zip(end_fns, end_acc):
                    prep = getattr(fn, "prepare", None)
                    p, lab = prep(yp, yy) if prep is not None else (yp, yy)
                    ps.append(p)
                    ls.append(lab)
        count = float(count)
        avg_loss = float(total) / count
        if dataset_type == "train":
            return avg_loss
        results: list = [avg_loss]
        if self.target_type in ("cat", "single_label"):
            results.append(float(correct) / count)
        elif self.target_type == "multi_label":
            cats = getattr(self.data, "categories", None)
            C = (len(cats) if cats is not None
                 else np.asarray(self.data.val_dl.peek().y).shape[-1])
            results.append(float(correct) / (count * C))
        if len(metrics):
            batch_vals = iter(mvals.cpu().numpy() / count)
            end_vals = iter(fn(np.concatenate(ps), np.concatenate(ls))
                            for fn, (ps, ls) in zip(end_fns, end_acc))
            results.append(np.asarray([
                next(end_vals) if M.is_end_metric(m) else next(batch_vals)
                for m in metrics]))
        return results

    def _eval_forward(self, xs):
        """Eval-mode forward of device tensors through the input pipeline;
        outputs float32."""
        xs = self._pipeline(xs, False)
        with self._autocast():
            return _to_f32(self.model(*xs, **self._model_kwargs(False)))

    @torch.no_grad()
    def predict1minibatch(self, xs):
        """Eval-mode forward on one batch (Learner.py:277-284); ``xs`` is a
        tuple of arrays or tensors, or one of them.  Outputs are float32."""
        if not isinstance(xs, (tuple, list)):
            xs = (xs,)
        xs = tuple(_as_batch_tensor(torch.as_tensor(
            np.asarray(x) if not torch.is_tensor(x) else x,
            device=self.device)) for x in xs)
        self.model.eval()
        return self._eval_forward(xs)

    @torch.no_grad()
    def predict(self, dl, correct_probs: bool = True):
        """Predictions over a whole loader, or 'train' / 'val' / 'test'
        (Learner.py:286-393): a (N, ...) array for 'cont' targets, else
        [probs, labels] (softmax and argmax for 'cat', 'single_label' and
        'text_classify', sigmoid and rounding for 'multi_label';
        ``correct_probs=False`` gives the logits in place of the
        probabilities)."""
        if isinstance(dl, str):
            dl = {"train": self.data.train_dl, "val": self.data.val_dl,
                  "test": getattr(self.data, "test_dl", None)}[dl]
        self.model.eval()
        outs = []
        for batch, (xs, _, _) in self._device_batches(dl):
            y_pred = self._eval_forward(xs)
            if isinstance(y_pred, tuple):
                y_pred = y_pred[0]
            outs.append(y_pred[:batch.n_valid])
        y_pred = torch.cat(outs)
        if self.target_type == "cont":
            return y_pred.cpu().numpy()
        if self.target_type == "multi_label":
            probs = torch.sigmoid(y_pred)
            labels = torch.round(probs).long()
        elif self.target_type in ("cat", "single_label", "text_classify"):
            probs = torch.softmax(y_pred, dim=1)
            labels = probs.argmax(1)
        else:
            raise ValueError(f"predict takes 'cont', 'cat', 'single_label', "
                             f"'text_classify' or 'multi_label' targets, "
                             f"not {self.target_type!r}")
        probs = probs if correct_probs else y_pred
        return [probs.cpu().numpy(), labels.cpu().numpy()]

    # ------------------------------------------------ training

    def init_optimizer(self, wd=None, bn_wd=None, clip=None):
        """Training-period hyperparameters (Learner.py:680-688)."""
        self.optimizer.set_params(wd=wd, bn_wd=bn_wd, clip=clip)

    get_sched = staticmethod(get_sched)

    @staticmethod
    def display_training_results(col_names, values, run_times,
                                 first_epoch=0, header=True):
        """Epoch results table (Learner.py:518-526)."""
        if header:
            print("epoch".ljust(8) + "".join(c.ljust(12) for c in col_names))
        for n, row in enumerate(values):
            vals = ["{:.5f}".format(v) for v in row]
            print(str(first_epoch + n).ljust(8)
                  + "".join(v.ljust(12) for v in vals) + run_times[n])

    def train_gen_sched(self, lr_sched, mom_sched=None, betas_sched=None,
                        metrics: Sequence = (), print_batch=False,
                        save_name: Optional[str] = None,
                        save_method: Optional[str] = "best",
                        swa_freq: Optional[int] = None, fused: bool = False):
        """Train with arbitrary per-minibatch schedules (Learner.py:528-678):
        evaluate 'val' first, then per epoch the train steps, the debiased
        train-loss EMA, 'val', best/all checkpointing, and the early stop
        at val_loss > 20 * min_loss."""
        if swa_freq:
            raise NotImplementedError(f"SWA (swa_freq=) {_TODO}")
        if fused:
            raise NotImplementedError(f"fused epochs {_TODO}")
        if save_name is None:
            save_method = None
        spe = len(self.data.train_dl)
        if len(lr_sched) % spe != 0:
            raise ValueError("len(lr_sched) must be an integer multiple of "
                             "len(train_dl)")
        num_epochs = len(lr_sched) // spe
        self.loss_sched, self.lr_sched = [], []
        self.mom_sched, self.betas_sched = [], []
        self.moving_avg_loss = 0.0
        self._ema.zero_()

        min_loss = _first(self.evaluate("val"))
        if save_name:
            self.save(save_name)
        values, run_times = [], []
        col_names = ["train_loss", "val_loss"]
        if self.target_type in ("cat", "single_label", "multi_label"):
            col_names.append("accuracy")
        if len(metrics):
            col_names.append("metrics")
        i = 0
        for n in range(num_epochs):
            start = time.time()
            for j, (batch, (xs, y, mask)) in enumerate(
                    self._device_batches(self.data.train_dl)):
                self.lr_sched.append(lr_sched[i])
                mom_i = mom_sched[i] if mom_sched is not None else None
                betas_i = betas_sched[i] if betas_sched is not None else None
                if mom_i is not None:
                    self.mom_sched.append(mom_i)
                if betas_i is not None:
                    self.betas_sched.append(betas_i)
                with tracing.span("learner.step",
                                  step=self._global_step + 1):
                    loss = self._step(xs, y, mask, batch.n_valid,
                                      lr_sched[i], mom_i, betas_i)
                self.loss_sched.append(loss)
                i += 1
                if print_batch is True or (isinstance(print_batch, int)
                                           and print_batch
                                           and j % print_batch == 0):
                    debiased = float(self._ema) / (1 - _EMA_DECAY ** i)
                    print(f"batch {j}: avg_loss {debiased:.5f}  "
                          f"batch_loss {float(loss):.5f}")
            debiased = float(self._ema) / (1 - _EMA_DECAY ** i)
            self.moving_avg_loss = debiased
            train_loss = (debiased if self.use_moving_avg
                          else self.evaluate("train"))
            res = self.evaluate("val", metrics)
            val_loss = res[0]
            values.append([train_loss] + _flatten_results(res))
            mins, secs = divmod(time.time() - start, 60)
            run_times.append("  epoch run time: %d min, %.2f sec"
                             % (mins, secs))
            self.display_training_results(col_names, values[-1:],
                                          run_times[-1:], first_epoch=n,
                                          header=(n == 0))
            if val_loss < min_loss:
                min_loss = val_loss
                if save_method == "best":
                    self.save(save_name)
            if save_method == "all":
                self.save(save_name + "_" + str(n))
            if val_loss > 20 * min_loss:  # Learner.py:673-675
                print("val_loss increased too much, stopping training early")
                break
        self.values, self.run_times = values, run_times

    def fit(self, lr, num_epochs, wd=None, bn_wd=None, clip=None,
            momentum=None, betas=None, metrics=(), print_batch=False,
            save_name=None, save_method="best", swa_freq=None, fused=False):
        """Constant-lr training (Learner.py:730-744)."""
        self._check_lr_len(lr)
        self.init_optimizer(wd, bn_wd, clip)
        N = num_epochs * len(self.data.train_dl)
        self.train_gen_sched([lr] * N, [momentum] * N if momentum else None,
                             [betas] * N if betas else None, metrics,
                             print_batch, save_name, save_method, swa_freq,
                             fused)

    def fit_cycles(self, lr_start, lr_end, num_cycles, cycle_type="cos",
                   base_length=1, cycle_mult=1, wd=None, bn_wd=None,
                   clip=None, momentum=None, betas=None, metrics=(),
                   print_batch=False, save_name=None, save_method="best",
                   swa_freq=None, fused=False):
        """SGDR annealing with restarts (Learner.py:746-774)."""
        self._check_lr_len(lr_start)
        self._check_lr_len(lr_end)
        self.init_optimizer(wd, bn_wd, clip)
        lr_sched = cycles_sched(len(self.data.train_dl), lr_start, lr_end,
                                num_cycles, cycle_type, base_length,
                                cycle_mult)
        N = len(lr_sched)
        self.train_gen_sched(lr_sched, [momentum] * N if momentum else None,
                             [betas] * N if betas else None, metrics,
                             print_batch, save_name, save_method, swa_freq,
                             fused)

    def fit_one_cycle(self, lr_max, num_epochs, div_fac=25, start_pct=0.3,
                      wd=None, bn_wd=None, clip=None, mom_min=0.85,
                      mom_max=0.95, beta_min=0.85, beta_max=0.95, metrics=(),
                      print_batch=False, save_name=None, save_method="best",
                      fused=False):
        """1cycle training (Learner.py:776-802)."""
        self._check_lr_len(lr_max)
        self.init_optimizer(wd, bn_wd, clip)
        N = num_epochs * len(self.data.train_dl)
        s = one_cycle_scheds(N, lr_max, div_fac, start_pct, mom_min,
                             mom_max, beta_min, beta_max)
        mom_sched = list(s["mom"]) if self.optimizer.uses_momentum else None
        betas_sched = ([(float(b), self.optimizer.betas[1])
                        for b in s["beta1"]]
                       if self.optimizer.uses_betas else None)
        self.train_gen_sched(list(s["lr"]), mom_sched, betas_sched, metrics,
                             print_batch, save_name, save_method,
                             fused=fused)

    def find_lr(self, lr_min=1e-5, lr_max=1.0, wd=None, bn_wd=None,
                clip=None, momentum=None, betas=None, length="1epoch",
                break_fac=3, sched_type="exp", plot=False):
        """LR range test (Learner.py:804-887): train with a rising lr,
        record ``loss_sched``/``lr_sched``, then restore the starting
        checkpoint.  Plotting is not ported."""
        if plot:
            raise NotImplementedError(f"find_lr plotting {_TODO}")
        self._check_lr_len(lr_min)
        self._check_lr_len(lr_max)
        self.save("temp", save_optimizer=True)
        self._ema.zero_()
        self.loss_sched, self.lr_sched = [], []
        self.init_optimizer(wd, bn_wd, clip)
        spe = len(self.data.train_dl)
        N = spe if length == "1epoch" else int(length)
        lr_sched = get_sched(sched_type, N, lr_min, lr_max)
        initial_loss, i = None, 0
        while i < N:
            for batch, (xs, y, mask) in self._device_batches(
                    self.data.train_dl):
                with tracing.span("learner.step",
                                  step=self._global_step + 1):
                    loss = self._step(xs, y, mask, batch.n_valid,
                                      lr_sched[i], momentum, betas)
                self.loss_sched.append(float(loss))
                self.lr_sched.append(lr_sched[i])
                i += 1
                debiased = float(self._ema) / (1 - _EMA_DECAY ** i)
                if initial_loss is None:
                    initial_loss = debiased
                if (break_fac and debiased > break_fac * initial_loss) \
                        or i == N:
                    i = N
                    break
        self.load("temp", saved_optimizer=True)

    def _check_lr_len(self, lr):
        if isinstance(lr, (list, tuple)) and len(lr) != self.n_groups:
            raise ValueError(f"per-group lr list has length {len(lr)}, "
                             f"expected {self.n_groups} layer groups")


def _as_batch_tensor(t: torch.Tensor) -> torch.Tensor:
    """uint8 and floats as they are, other integer types as int64."""
    if t.is_floating_point() or t.dtype == torch.uint8:
        return t
    return t.long()


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


def _flatten_results(res) -> list:
    out = []
    for v in res:
        out.extend(float(x) for x in np.atleast_1d(v))
    return out
