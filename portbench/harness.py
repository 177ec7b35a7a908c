"""One run of one cell, in the order of a run:

1. load the port's kernels (built into the port's own ``_build/`` on a
   checkout's first run);
2. make the weights from ``--seed`` on the device;
3. make the traffic from ``--seed`` (the mix's generator, the program's
   packer);
4. build the ``Learner`` and drive its first steps (the configuration's
   ``check_steps``) through the window's own call and feed: they warm up
   the cell's one shape and give the program's readings for the
   comparison;
5. the timed window: ``Learner.train1minibatch`` on successive loader
   batches until ``--seconds`` have passed, then one synchronize; with
   ``--trace 1`` a slice of whole steps inside it under ``torch.profiler``;
6. free the program, run the plain reference over the same first steps,
   compare;
7. print the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration's
file names a family (``families/<family>.py``: how the port builds it,
and its reference ``reference/<family>.py``), its traffic a mix
(``traffic/<mix>.json``), and each per-layer metric a reader
(``layer_metrics/<metric>.py``); the limits of ``correct`` are the
configuration's, ``limits/<config>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from portbench import correctness, roofline, trace, traffic
from portbench.reference import common

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that no run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuralnetworklibrary_tpu")
SLICE_STEPS = 4          # the traced slice: the window's last steps


def _json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _for_cell(entries, workload):
    return [e for e in entries if workload in e.get("workloads", [workload])]


def resolve(workload: str, bench: dict) -> dict:
    """The cell ``workload`` of the manifest ``bench``, with its
    configuration, mix, limits and metrics, each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config": _json(os.path.join(ROOT, conf["file"])),
            "mix": traffic.load(cell["traffic"]),
            "limits": limits(cell["config"]),
            "end_to_end": _for_cell(bench["end_to_end"], workload),
            "per_layer": _for_cell(bench["per_layer"], workload)}


def limits(config: str) -> dict:
    return _json(os.path.join(HERE, "limits", config + ".json"))["limits"]


def family(cfg: dict):
    return importlib.import_module(f"portbench.families.{cfg['family']}")


def layer_metric(name: str):
    """The reader ``layer_metrics/<name>.py``; its ``read(ctx)`` gives the
    metric's value, or None where it finds nothing to read."""
    path = os.path.join(HERE, "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- traffic

def make_pool(cfg: dict, mix: dict, seed: int) -> dict:
    """The run's rows (``traffic.make``) and, per batch of the pool, its
    loss-bearing tokens, their model FLOPs and the attended pairs of one
    head and layer."""
    from neuralnetworklibrary_tpu_torch.data.packing import pack_documents

    dims = family(cfg).dims(cfg)
    pool = traffic.make(mix, cfg["bench"], seed, pack=pack_documents)
    x, y, B = pool["x"], pool["y"], mix["rows"]
    keys = roofline.keys_per_position(x, dims["separator"])
    pad = cfg["bench"]["pad"]
    w = np.ones(y.shape, bool) if pad is None else y != pad
    n = len(x) // B
    rows = [slice(i * B, (i + 1) * B) for i in range(n)]
    pool.update(
        rows=B, dims=dims,
        tokens=[int(w[r].sum()) for r in rows],
        flops=[roofline.model_flops(keys[r], w[r], dims["n_matmul"],
                                    dims["L"], dims["H"], dims["hd"])
               for r in rows],
        pairs=[int(keys[r].sum()) for r in rows])
    return pool


# ---------------------------------------------------------------- program

def build_learner(cfg: dict, weights: dict, pool: dict, seed: int, device,
                  path: str):
    """The port's ``Learner`` over a loader of the pool's rows, training
    the leaves the configuration has (``family.trainable``)."""
    from neuralnetworklibrary_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner

    fam, tr = family(cfg), cfg["train"]
    model = fam.build(cfg, weights, device)
    dl = DataLoader(ArrayDataset(pool["x"], pool["y"]), pool["rows"],
                    prefetch=0)
    data = types.SimpleNamespace(target_type="lang_model", bs=pool["rows"],
                                 train_dl=dl, val_dl=dl)
    learner = Learner(path, data, model, tr["optimizer"],
                      loss_func=fam.loss_func(cfg), seed=seed,
                      compute_dtype=(None if tr["dtype"] == "float32"
                                     else tr["dtype"]), device=device)
    learner.init_optimizer(wd=tr["wd"])
    learner.set_trainable(lambda p: fam.trainable(cfg, ".".join(p)))
    return learner


def feed(learner):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from learner.data.train_dl


def _rows(t, rows):
    return t if rows is None else t[rows[0]:rows[1]]


def _check_cover(leaf_map: dict, params: dict, trained) -> None:
    """Every trained leaf of the program is held whole by the reference's
    leaves: its rows tiled once, or the leaf taken whole."""
    parts = {}
    for port, rows in leaf_map.values():
        parts.setdefault(port, []).append(rows)
    for name in trained:
        n = params[name].shape[0]
        got = sorted((0, n) if r is None else r for r in parts.get(name, []))
        if [a for a, _ in got] != [0] + [b for _, b in got[:-1]] or (
                not got or got[-1][1] != n):
            raise ValueError(f"the reference does not hold {name} once")
    odd = set(parts) - set(trained)
    if odd:
        raise ValueError(f"leaves the program does not train: {sorted(odd)}")


def program_steps(cfg: dict, learner, batches, n: int,
                  tensors: bool = False) -> dict:
    """The first ``n`` steps through ``Learner.train1minibatch``, and the
    program's readings by the reference's leaves (``family.leaf_map``):
    each step's loss, each leaf's squared gradient norm at step 1 (from
    Adam's first moment, m = (1 - b1) g) and its squared change after
    step n; with ``tensors`` also ``grads``, each leaf's step-1 gradient
    on the host, in the port's layout."""
    fam, lr = family(cfg), cfg["train"]["lr"]
    b1 = learner.optimizer.betas[0]
    paths = {".".join(p): p for p in learner.params}
    params = {k: learner.params[p] for k, p in paths.items()}
    trained = [k for k in paths if fam.trainable(cfg, k)]
    leaf_map = fam.leaf_map(cfg)
    _check_cover(leaf_map, params, trained)
    start = {k: params[k].detach().clone() for k in trained}
    losses, grad_sq, grads = [], {}, {}
    for i in range(n):
        losses.append(learner.train1minibatch(next(batches), lr))
        if i == 0:
            grad_sq = {ref: float(_rows(learner.opt_state[paths[port]]["m"],
                                        rows).double().square().sum())
                       / (1.0 - b1) ** 2
                       for ref, (port, rows) in leaf_map.items()}
            if tensors:
                grads = {ref: (_rows(learner.opt_state[paths[port]]["m"],
                                     rows).float() / (1.0 - b1)).cpu()
                         for ref, (port, rows) in leaf_map.items()}
    change_sq = {ref: float(_rows(params[port].detach() - start[port], rows)
                            .double().square().sum())
                 for ref, (port, rows) in leaf_map.items()}
    out = {"losses": [float(v) for v in losses], "grad_sq": grad_sq,
           "change_sq": change_sq}
    if tensors:
        out["grads"] = grads
    return out


def _half_batch(learner):
    loss = learner.loss_func

    def half(outputs, target, mask=None):
        n = target.shape[0] // 2
        out = (tuple(o[:n] for o in outputs) if isinstance(outputs, tuple)
               else outputs[:n])
        return loss(out, target[:n], None if mask is None else mask[:n])

    learner.loss_func = half


# faults planted under the timed path, for the checks that a broken step
# reads as not correct (control.py and the tests; a run plants none)
FAULTS = {
    "unchanged": lambda learner: setattr(learner.optimizer, "apply",
                                         lambda *a, **kw: None),
    "half_batch": _half_batch,
}


def _warm_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        _sync(device)


class _Slice:
    """The traced slice: torch.profiler over whole steps, CUDA events
    around the optimizer, and the host time of each step."""

    def __init__(self, learner):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.opt, self.apply = learner.optimizer, learner.optimizer.apply
        self.events = []

        def timed(*args, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = self.apply(*args, **kw)
            e1.record()
            self.events.append((e0, e1))
            return out

        self.opt.apply = timed
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def close(self):
        self.prof.__exit__(None, None, None)
        del self.opt.apply
        return [e0.elapsed_time(e1) / 1e3 for e0, e1 in self.events]


def window(learner, batches, lr: float, seconds: float, device,
           traced: bool) -> dict:
    """``train1minibatch`` on successive batches until ``seconds`` have
    passed on the host clock, then one synchronize, and no other.  With
    ``traced`` the window ends in a slice of ``SLICE_STEPS`` whole steps
    under the profiler, between two synchronizes; the profiler's trace is
    read after the window."""
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, host_s = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(learner.train1minibatch(next(batches), lr))
    if traced:
        sl = _Slice(learner)
        for _ in range(SLICE_STEPS):
            h0 = time.perf_counter()
            losses.append(learner.train1minibatch(next(batches), lr))
            host_s.append(time.perf_counter() - h0)
    _sync(device)
    out = {"seconds": time.perf_counter() - t0, "losses": losses,
           "peak": torch.cuda.max_memory_allocated() if cuda else 0}
    if traced:
        out["optimizer_s"] = sl.close()
        out["device"], out["host"] = trace.profiler_events(sl.prof)
        out["host_step_s"] = host_s
    return out


# ---------------------------------------------------------------- reference

@contextlib.contextmanager
def _float32_products():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    common.no_tf32()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def reference_steps(cfg: dict, pool: dict, seed: int, n: int, mode: str,
                    device, tensors: bool = False) -> dict:
    """The reference's readings over the same first ``n`` batches, from
    weights made again from the seed; with ``tensors`` also its step-1
    gradients, put in the port's layout (``family.port_layout``)."""
    fam, tr, B = family(cfg), cfg["train"], pool["rows"]
    weights = fam.make_weights(cfg, seed, device)
    params = fam.reference.params(weights)
    del weights
    batches = [tuple(torch.from_numpy(a[i * B:(i + 1) * B]).long().to(device)
                     for a in (pool["x"], pool["y"])) for i in range(n)]
    opt = {k: tr[k] for k in ("lr", "wd", "betas", "eps")}
    with _float32_products():
        out = common.train(
            params, lambda p, x, y: fam.reference.loss(
                p, x, y, cfg, cfg["bench"], mode), batches, opt, tensors)
    if tensors:
        out["grads"] = {k: fam.port_layout(k, g)
                        for k, g in out["grads"].items()}
    return out


def wants_tensors(spec: dict) -> bool:
    """Whether the cell's limits compare whole gradients (``grad_diff``),
    so both sides keep them."""
    return "grad_diff" in spec["limits"]


def compare(cfg: dict, pool: dict, prog: dict, ref: dict) -> tuple:
    """The numbers compared and where each was largest."""
    values, where = correctness.numbers(prog, ref)
    if "docs" in pool:
        values["packing_faults"] = correctness.packing_faults(
            pool["docs"], *pool["packed"], cfg["bench"]["separator"],
            cfg["bench"]["pad"])
    return values, where


def release():
    """Hand the memory of what was just dropped back to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- a run

def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, fault=None) -> dict:
    """One run of the cell ``spec`` (from :func:`resolve`); returns the
    result line as a dict.  ``fault`` plants one of :data:`FAULTS`."""
    cfg, mix = spec["config"], spec["mix"]
    fam, checks = family(cfg), cfg["train"]["check_steps"]
    phases, mark = {}, [t_start]

    def phase(name):
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    phase("start")
    built = False
    if torch.device(device).type == "cuda":
        from neuralnetworklibrary_tpu_torch.kernels import build

        built = any(build.stale(build.library_path(name),
                                build.CSRC / f"{name}.cu")
                    for name in fam.KERNELS)
        for name in fam.KERNELS:
            build.load(name)
    phase("kernels")
    weights = fam.make_weights(cfg, seed, device)
    phase("weights")
    pool = make_pool(cfg, mix, seed)
    phase("traffic")
    with tempfile.TemporaryDirectory() as tmp:
        learner = build_learner(cfg, weights, pool, seed, device, tmp)
        del weights
        release()
        phase("learner")
        if fault:
            FAULTS[fault](learner)
        batches = feed(learner)
        prog = program_steps(cfg, learner, batches, checks,
                             wants_tensors(spec))
        phase("first_steps")
        if traced:   # the profiler's first start loads seconds of modules
            _warm_profiler(device)
            phase("profiler")
        setup_s = time.perf_counter() - t_start
        win = window(learner, batches, cfg["train"]["lr"], seconds, device,
                     traced)
        del learner, batches
        release()
    n_pool = len(pool["tokens"])
    steps = [(checks + k) % n_pool for k in range(len(win["losses"]))]
    losses = [float(v) for v in win["losses"]]
    tokens = sum(pool["tokens"][i] for i in steps)
    flops = sum(pool["flops"][i] for i in steps)
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, pool, seed, checks, "float32", device,
                          wants_tensors(spec))
    values, where = compare(cfg, pool, prog, ref)
    print(f"portbench: setup {setup_s:.2f} s"
          f"{' (kernels built in this run)' if built else ''}, window "
          f"{win['seconds']:.2f} s, reference "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    failed = sum(not math.isfinite(v) for v in losses)
    res = {"correct": failed == 0 and correctness.judge(values,
                                                         spec["limits"]),
           "attempted": len(losses), "failed": failed}
    e2e = {"setup_s": setup_s, "train_tokens_per_s": tokens / win["seconds"],
           "peak_mem_gb": win["peak"] / 1e9}
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                   else torch.device(device).type,
                   "kind": (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else "cpu"),
                   "count": 1, "memory_peak_bytes": win["peak"],
                   "power_limit_w": _power_limit()}
    if traced:
        red = trace.reduce(win["device"], win["host"])
        sl = steps[-SLICE_STEPS:]
        ctx = {"dims": pool["dims"], "rows": pool["rows"],
               "seq_len": pool["x"].shape[1], "dtype": cfg["train"]["dtype"],
               "window_s": win["seconds"], "model_flops": flops,
               "slice_steps": len(sl), "span_s": red["span_s"],
               "busy_s": red["busy_s"], "device_events": win["device"],
               "host_step_s": win["host_step_s"],
               "optimizer_s": win["optimizer_s"],
               "pairs": [pool["pairs"][i] for i in sl]}
        got = {m["name"]: layer_metric(m["name"]).read(ctx)
               for m in spec["per_layer"]}
        res["metrics"] = {m["name"]: {"value": got[m["name"]],
                                      "unit": m["unit"]}
                          for m in spec["per_layer"]
                          if got[m["name"]] is not None}
        device_info.update(busy_s=red["busy_s"], window_s=red["span_s"])
        if red["breakdown"]:
            res["breakdown"] = red["breakdown"]
        res["traced_train_tokens_per_s"] = e2e["train_tokens_per_s"]
    else:
        res["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in spec["end_to_end"]}
    res["device"] = device_info
    # a run that built the kernels (a checkout's first) is marked apart:
    # its setup_s holds the build
    res["first_run"] = {"built_kernels": built,
                        "build_s": phases["kernels"] if built else 0.0}
    res["setup_phases_s"] = phases
    res["where"] = where
    res["losses"] = {"program": prog["losses"], "reference": ref["losses"],
                     "reference_step_s": ref["step_s"]}
    res["checks"] = {k: {"value": v, "limit": spec["limits"].get(k)}
                     for k, v in values.items()}
    return res


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(args.workload, manifest())
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
