"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing one JSON line (the first line printed is the card's
name and power limit from nvidia-smi):

- build:  compile every CUDA source of the port with nvcc, in parallel.
- kernel: each kernel against its plain PyTorch version on the card, over
          dtypes, head layouts, block sizes, windows, sinks, offset edges
          and shared table rows, and at the serving path's own shape.
- serve:  GPT-2-124M at full width (random weights from --seed, loaded
          through load_jax_params): (a) one f32 paged decode step, kernel
          path against gather path; (b) bf16 PagedServingEngine over 16
          greedy requests.  Kernel launches are counted over (b) alone.
- timing: CUDA-event medians with the L2 cache flushed before each call.

--profile adds a torch.profiler breakdown of one more serve run by kernel.

Then a "kernels" line with every ported kernel, and last the line
{"ok": true, "device": {...}}.  Any failure exits non-zero; no phase
catches an error and carries on.  Without a CUDA device it exits 2 before
printing anything else.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "neuralnetworklibrary_tpu/ops/paged_attention.py:68"
SOURCE = "neuralnetworklibrary_tpu_torch/csrc/paged_attention.cu"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (hopper-kernels guide, table 1)
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GPT2 = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12,
            max_len=1024, norm_eps=1e-5)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------- inputs


def paged_case(rng, B, H, Hkv, hd, bs, MB, pool_dtype, q_dtype, offsets,
               share=False, N=None):
    """Random q, pools, table and offsets on the card; row 0 is trash."""
    N = N or B * MB + 1
    q = torch.from_numpy(rng.normal(0, 1, (B, H, hd)).astype(np.float32))
    if pool_dtype == torch.int8:
        pk = torch.from_numpy(rng.integers(-127, 128, (N, bs, Hkv, hd),
                                           dtype=np.int8))
        pv = torch.from_numpy(rng.integers(-127, 128, (N, bs, Hkv, hd),
                                           dtype=np.int8))
        sk = torch.from_numpy(rng.uniform(0.001, 0.02, (N, bs, Hkv))
                              .astype(np.float32))
        sv = torch.from_numpy(rng.uniform(0.001, 0.02, (N, bs, Hkv))
                              .astype(np.float32))
    else:
        pk = torch.from_numpy(rng.normal(0, 1, (N, bs, Hkv, hd))
                              .astype(np.float32))
        pv = torch.from_numpy(rng.normal(0, 1, (N, bs, Hkv, hd))
                              .astype(np.float32))
        sk = sv = None
    rows = rng.permutation(np.arange(1, N))[:B * MB].reshape(B, MB)
    if share:   # prefix sharing: every slot's first blocks alias slot 0's
        rows[:, :MB // 2] = rows[0, :MB // 2]
    off = np.asarray(offsets, np.int32)
    for b in range(B):   # unallocated logical blocks point at trash row 0
        rows[b, off[b] // bs + 1:] = 0
    dev = "cuda"
    return dict(
        q=q.to(dev, q_dtype),
        pool_k=pk.to(dev, None if pool_dtype == torch.int8 else pool_dtype),
        pool_v=pv.to(dev, None if pool_dtype == torch.int8 else pool_dtype),
        block_table=torch.from_numpy(rows.astype(np.int32)).to(dev),
        offsets=torch.from_numpy(off).to(dev),
        pool_k_scale=None if sk is None else sk.to(dev),
        pool_v_scale=None if sv is None else sv.to(dev))


def as_f32(case):
    """The same inputs in float32 (bf16 values are exact in f32)."""
    return {k: (v.float() if v is not None and v.is_floating_point() else v)
            for k, v in case.items()}


# ------------------------------------------------------------- timing


class Timer:
    """Median CUDA-event time of one call, with a 512 MB write before each
    call so the call finds its inputs outside the 50 MB L2, as a decode step
    does after the other layers' weights have passed through."""

    def __init__(self):
        self.flush = torch.empty(128 << 20, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps=30, warmup=3):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def paged_bound(case):
    """Least time for the work of this call: the K/V rows the offsets make
    attendable (plus q, out, table, offsets, scales) over HBM bandwidth,
    against 4*H*hd operations per attended position at the input type's
    peak.  Returns (ms, "bytes" | "operations")."""
    q, pk = case["q"], case["pool_k"]
    B, H, hd = q.shape
    Hkv = pk.shape[2]
    n_pos = int((case["offsets"].long() + 1).sum())
    kv = 2 * n_pos * Hkv * hd * pk.element_size()
    if case["pool_k_scale"] is not None:
        kv += 2 * n_pos * Hkv * 4
    nbytes = (kv + 2 * q.numel() * q.element_size()
              + case["block_table"].numel() * 4 + B * 4)
    ops = 4 * H * hd * n_pos
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phases


def phase_build():
    from neuralnetworklibrary_tpu_torch.kernels import build

    t0 = time.perf_counter()
    res = build.build()
    ptxas = {n: [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, r in res.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {n: r["seconds"] for n, r in res.items()},
          "ptxas": ptxas})


def phase_kernel(seed):
    from neuralnetworklibrary_tpu_torch.ops.paged_attention import (
        paged_attention,
        reference_paged_attention,
    )

    rng = np.random.default_rng(seed)
    worst = {}
    n_cases = 0
    for pool_dtype, q_dtype in ((torch.float32, torch.float32),
                                (torch.bfloat16, torch.bfloat16),
                                (torch.int8, torch.float32)):
        for H, Hkv, hd in ((12, 12, 64), (32, 8, 128), (8, 2, 16)):
            for bs in (16, 32, 64):
                MB = 4
                last = MB * bs - 1
                offsets = [0, bs - 1, bs, last,
                           int(rng.integers(0, last + 1)),
                           int(rng.integers(0, last + 1))]
                for window in (0, bs + 3):
                    for with_sink in (False, True):
                        case = paged_case(rng, 6, H, Hkv, hd, bs, MB,
                                          pool_dtype, q_dtype, offsets,
                                          share=window > 0)
                        sink = (torch.from_numpy(rng.normal(0, 1, H)
                                                 .astype(np.float32))
                                .cuda() if with_sink else None)
                        got = paged_attention(**case, window=window,
                                              sink=sink)
                        want = reference_paged_attention(
                            **as_f32(case), window=window, sink=sink)
                        torch.cuda.synchronize()
                        err = float((got.float() - want).abs().max())
                        key = str(pool_dtype).replace("torch.", "")
                        worst[key] = max(worst.get(key, 0.0), err)
                        tol = TOL[q_dtype]
                        if not err <= tol:
                            fail(f"paged_attention {key} H={H} Hkv={Hkv} "
                                 f"hd={hd} bs={bs} window={window} "
                                 f"sink={with_sink}: max|err| {err} > {tol}")
                        n_cases += 1
    # the serving path's own shape: GPT-2 heads, bf16, 8 slots, bs 32
    main = paged_case(rng, 8, 12, 12, 64, 32, 32, torch.bfloat16,
                      torch.bfloat16, rng.integers(0, 1024, 8), N=257)
    got = paged_attention(**main)
    want = reference_paged_attention(**as_f32(main))
    main_err = float((got.float() - want).abs().max())
    if not main_err <= TOL[torch.bfloat16]:
        fail(f"paged_attention at the serving shape: max|err| {main_err}")
    emit({"phase": "kernel", "kernel": "paged_attention", "cases": n_cases,
          "max_abs_err": worst, "tol": {"float32": TOL[torch.float32],
                                        "bfloat16": TOL[torch.bfloat16],
                                        "int8": TOL[torch.float32]},
          "serving_shape_max_abs_err": main_err})
    return main_err


def gpt2_params(seed, cfg):
    """A flax-shaped params tree for TransformerLM(**cfg): dense kernels
    and embeddings normal(0, 0.02) from numpy, biases 0, norm scales 1."""
    rng = np.random.default_rng(seed)
    D, V, M = cfg["d_model"], cfg["vocab_size"], cfg["max_len"]

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": np.zeros(o, np.float32)}

    def norm():
        return {"scale": np.ones(D, np.float32),
                "bias": np.zeros(D, np.float32)}

    tree = {"word_embed": normal(V, D), "pos_embed": normal(M, D),
            "ln_f": norm()}
    for i in range(cfg["n_layers"]):
        tree[f"block_{i}"] = {
            "ln1": norm(), "ln2": norm(),
            "attn": {"qkv": dense(D, 3 * D), "out": dense(D, D)},
            "mlp": {"fc_in": dense(D, 4 * D), "fc_out": dense(4 * D, D)}}
    return tree


def profile_serve(engine_fn, requests):
    """Device time by kernel over one engine run under torch.profiler, and
    its share of the run's wall time (the profiler's own cost inflates the
    wall time, so the busy share it gives is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    engine = engine_fn()
    reqs = requests(8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # kernels only: an aten op's row repeats its kernels' device time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    emit({"phase": "serve_profile", "requests": len(reqs),
          "decode_steps": engine.stats["decode_steps"],
          "wall_ms_profiled": wall * 1e3, "device_ms": total_ms,
          "device_busy_share": total_ms / (wall * 1e3),
          "top_kernels": [{"name": k[:90], "ms": us / 1e3, "calls": n,
                           "share": us / 1e3 / total_ms}
                          for us, k, n in rows[:12]]})


def phase_serve(seed, profile=False):
    from neuralnetworklibrary_tpu_torch.nn.transformer import (
        TransformerLM,
        init_cache,
    )
    from neuralnetworklibrary_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from neuralnetworklibrary_tpu_torch.serving import (
        PagedServingEngine,
        Request,
    )
    from neuralnetworklibrary_tpu_torch.utils.jax_params import (
        load_jax_params,
    )

    bs, n_blocks, slots = 32, 257, 8
    t0 = time.perf_counter()
    model = TransformerLM(**GPT2, paged_kv_blocks=n_blocks,
                          paged_kv_block=bs)
    load_jax_params(model, gpt2_params(seed, GPT2))
    model.eval()
    setup_s = time.perf_counter() - t0
    V, L = GPT2["vocab_size"], GPT2["n_layers"]

    # (a) f32: one paged decode step over 8 slots at mixed offsets, kernel
    # path against gather path on identical caches
    rng = np.random.default_rng(seed + 2)
    offsets = np.array([0, 31, 32, 100, 255, 511, 700, 1023], np.int32)
    table = np.zeros((slots, n_blocks // slots), np.int32)
    rows = iter(rng.permutation(np.arange(1, n_blocks)))
    for s, off in enumerate(offsets):
        for j in range(off // bs + 1):
            table[s, j] = next(rows)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_cache(model, slots)
    for name, layer in cache.items():
        if name != "idx":
            for t in layer["attn"].values():
                t.normal_(generator=gen)
    cache_g = {n: ({"attn": {k: t.clone() for k, t in c["attn"].items()}}
                   if n != "idx" else c) for n, c in cache.items()}
    toks = torch.from_numpy(rng.integers(0, V, (slots, 1))).cuda()
    kw = dict(decode=True,
              offsets=torch.from_numpy(offsets).cuda(),
              block_table=torch.from_numpy(table).cuda())
    with torch.no_grad():
        model.paged_attention = True
        logits_k, _ = model(toks, cache=cache, **kw)
        model.paged_attention = False
        logits_g, _ = model(toks, cache=cache_g, **kw)
        model.paged_attention = True
    torch.cuda.synchronize()
    if logits_k.shape != (slots, 1, V) or not torch.isfinite(logits_k).all():
        fail(f"f32 decode logits {tuple(logits_k.shape)} not finite/shaped")
    f32_err = float((logits_k - logits_g).abs().max())
    if not f32_err <= 1e-3:
        fail(f"f32 kernel vs gather logits: max|err| {f32_err} > 1e-3")
    del cache, cache_g

    # (b) bf16 serving of 16 greedy requests; launches counted over this
    # run alone
    model.to(torch.bfloat16)

    def requests(n):
        return [Request(rng.integers(0, V, int(rng.integers(32, 225))),
                        int(rng.integers(32, 97))) for _ in range(n)]

    def make_engine():
        return PagedServingEngine(model, slots=slots, chunk=8,
                                  prompt_buckets=(64, 128, 256))

    make_engine().run(requests(2))                # warm-up, not counted
    engine = make_engine()
    reqs = requests(16)
    torch.cuda.synchronize()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = engine.stats["decode_steps"]
    if not all(r.finished and 1 <= len(r.tokens) <= r.max_new
               and all(0 <= t < V for t in r.tokens) for r in reqs):
        fail("a request did not finish with valid tokens")
    if launches != L * steps:
        fail(f"kernel launches {launches} != n_layers x decode steps "
             f"{L} x {steps}")
    emitted = sum(len(r.tokens) for r in reqs)
    emit({"phase": "serve", "model": "gpt2-124m", "setup_s": setup_s,
          "f32_kernel_vs_gather_max_abs_err": f32_err, "f32_tol": 1e-3,
          "dtype": "bfloat16", "requests": len(reqs),
          "tokens_emitted": emitted, "wall_s": wall,
          "tokens_per_s": emitted / wall, "decode_steps": steps,
          "wall_ms_per_decode_step": wall / steps * 1e3,
          "occupancy": engine.occupancy,
          "occupancy_saturated": engine.occupancy_saturated,
          "preemptions": engine.stats["preemptions"],
          "blocks_peak": engine.stats["blocks_peak"],
          "prefills": engine.stats["prefills"],
          "kernel_launches": launches})
    if profile:
        profile_serve(make_engine, requests)
    return launches


def phase_timing(seed):
    import torch.nn.functional as F

    from neuralnetworklibrary_tpu_torch.ops.paged_attention import (
        paged_attention,
        reference_paged_attention,
    )

    rng = np.random.default_rng(seed + 1)
    timer = Timer()
    rows = []
    for label, B, off in (("slice", 8, 511), ("long_context", 32, 1023)):
        case = paged_case(rng, B, 12, 12, 64, 32, 32, torch.bfloat16,
                          torch.bfloat16, [off] * B)
        # yardstick only, never called by the port: SDPA over the dense
        # strip gathered beforehand (the gather is not timed)
        Mp = 32 * 32
        tbl = case["block_table"].long()
        kd = case["pool_k"][tbl].reshape(B, Mp, 12, 64).transpose(1, 2)
        vd = case["pool_v"][tbl].reshape(B, Mp, 12, 64).transpose(1, 2)
        qd = case["q"][:, :, None, :]
        mask = (torch.arange(Mp, device="cuda")[None, None, None, :]
                <= case["offsets"].long()[:, None, None, None])
        ms = timer.ms(lambda: paged_attention(**case))
        plain_ms = timer.ms(lambda: reference_paged_attention(**case))
        library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        bound_ms, bound_by = paged_bound(case)
        row = {"shape": label, "B": B, "H": 12, "Hkv": 12, "hd": 64,
               "bs": 32, "offsets": off, "dtype": "bfloat16", "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention on the "
                          "pre-gathered strip (yardstick only)",
               "achieved_GBps": bound_ms / ms * HBM_BYTES_PER_S / 1e9
               if bound_by == "bytes" else None}
        emit({"phase": "timing", **row})
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel of a serve run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    main_err = phase_kernel(args.seed)
    launches = phase_serve(args.seed, args.profile)
    t = phase_timing(args.seed)[0]     # the serving path's own shape
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_err, "max_err": main_err,
        "tol": TOL[torch.bfloat16], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
