"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing one JSON line (the first line printed is the card's
name and power limit from nvidia-smi):

- build:  compile every CUDA source of the port with nvcc, in parallel.
- kernel: each kernel against its plain PyTorch version on the card.  The
          paged decode kernel over dtypes, head layouts, block sizes,
          windows, sinks, offset edges and shared table rows, and at the
          serving path's own shape.  The flash kernels (forward, dq, dk/dv)
          over float32 and bf16, hd 64 and 128, window 0 and > 0, dropout
          0 and 0.1, at T 1024 and at a T that is no multiple of the tile,
          and at the training path's own shape; and the kernels' dropout
          hash against the plain one bit for bit.
- serve:  GPT-2-124M at full width (random weights from --seed, loaded
          through load_jax_params): (a) one f32 paged decode step, kernel
          path against gather path; (b) bf16 PagedServingEngine over 16
          greedy requests.  Paged kernel launches are counted over (b).
- train:  the same GPT-2-124M through the port's Learner with
          flash_attention=True: (a) one f32 forward/backward at B 2, T 1024,
          flash path against the einsum path; (b) the bench.py
          configuration (bf16, B 8, T 1024, Adam2, lr 1e-4, wd 1e-6, drop 0),
          10 train1minibatch steps on one fixed batch, then one evaluate.
          Flash kernel launches are counted over (b).
- lstm:   K6 (LSTM forward scan) and K7 (backward scan) against their
          plain versions on the same bf16 inputs and residuals, B 1, 3, 64
          x T 1, 7, 75 x H 24, 400, 1150 and three shapes for the kernels'
          other paths, nonzero (h0, c0); and the
          autograd Function end to end (K6, K7 and the weight-gradient
          product) on the card against the same Function on the CPU, xp in
          float32 and in bf16.
- lm:     the AWD-LSTM 400-1150-3 of bench.py's bench_lm (vocab 30,001, bs
          64, bptt 75) through the port's Learner, on a random-token corpus
          built as bench.py builds it: (a) one f32 forward/backward at B 4,
          kernel path against the f32 step loop, and the time of one at
          B 64 on each path; (b) Adam2, lr 1e-3, wd
          1e-6, RegSeqCrossEntropyLoss(2, 1), default drops: 10
          train1minibatch steps on the loader's first window, then
          evaluate('val') with LanguageModelAccuracy; K6/K7 launches are
          counted over (b); (c) predict_from_string, k 1, 16 new tokens,
          with its K6 launches counted.
- timing: CUDA-event medians with the L2 cache flushed before each call.

--profile adds torch.profiler breakdowns by kernel of one more serve run,
of one more train step and of one more AWD-LSTM step.

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
FLASH_SOURCE = "neuralnetworklibrary_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "neuralnetworklibrary_tpu/ops/flash_attention.py:119",
    "flash_bwd_dq": "neuralnetworklibrary_tpu/ops/flash_attention.py:275",
    "flash_bwd_dkv": "neuralnetworklibrary_tpu/ops/flash_attention.py:338"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (hopper-kernels guide, table 1)
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# flash kernels, elementwise |got - want| <= atol + rtol*|want| against the
# plain version in float32 on the same inputs.  float32: only the order of
# the sums differs.  bf16: the kernels compute in float32 from bf16 inputs
# and round o, dq, dk, dv to bf16 (relative 2**-9, the rtol's share), and
# the backward takes delta = rowsum(dO * O) from the rounded o, as the JAX
# package does.  With unit-normal inputs that shifts delta by ~0.02 per
# row at hd 64-128 (~0.1 at the worst of 4096 rows), and dq, dk by
# sm_scale * that * |sum_c P K| ~ 0.013: the atol's share, with 2x margin.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
GPT2 = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12,
            max_len=1024, norm_eps=1e-5)
LSTM_SOURCE = "neuralnetworklibrary_tpu_torch/csrc/lstm_scan.cu"
LSTM_REPLACES = {"lstm_fwd": "neuralnetworklibrary_tpu/ops/pallas_lstm.py:49",
                 "lstm_bwd": "neuralnetworklibrary_tpu/ops/pallas_lstm.py:138"}
# K6/K7 against their plain versions on the same inputs, elementwise
# |got - want| <= atol + rtol*|want|.  Both round to bf16 at the same
# places and differ only in the order of the float32 sums, so a stored
# bf16 value (ys, cs, gates) may round the other way: one bf16 ulp, at most
# 2**-7 of the value (the forward's rtol); the float32 carry then drifts by
# what those flips feed into later steps, which the atol (one bf16 ulp at
# magnitude 1) covers.  K7 rounds each step's dgates to bf16 for the next
# dh product, so a flip there moves dh by an ulp of dgates times |w|,
# summed over 4H terms and carried over T steps: (1e-2, 1e-2).
LSTM_TOL = {"fwd": (4e-3, 2 ** -7), "bwd": (1e-2, 1e-2)}
# the autograd Function end to end, card against CPU: outputs as the
# forward above; each gradient within 2e-2 of its largest entry (dw sums
# T*B products of bf16 residuals, each off by at most an ulp)
LSTM_GRAD_TOL = 2e-2
# the LM at f32, kernel path against the float32 step loop: the kernel
# path rounds xp, w_hh and each step's h to bf16 (2**-9 relative), the
# loop does not.  The loss is a mean over 300 tokens' CE and the AR/TAR
# terms: 1e-3 relative; each parameter's gradient within 3e-2 of its
# largest entry (about 8 bf16 ulps).
LM_LOSS_RTOL, LM_GRAD_TOL = 1e-3, 3e-2
AWD_LSTM = dict(B=64, bptt=75, vocab=30000, steps=10, val_windows=6)


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


def flash_case(rng, B, T, H, hd, dtype):
    """Random q, k, v, do (B, T, H, hd) on the card in ``dtype``."""
    return [torch.from_numpy(rng.standard_normal((B, T, H, hd),
                                                 dtype=np.float32))
            .to("cuda", dtype) for _ in range(4)]


def flash_plain(q, k, v, do, window, dropout, seed):
    """The plain version in float32 on the same inputs: o, lse (B*H, T),
    dq, dk, dv."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        reference_flash_attention,
    )

    B, T, H, hd = q.shape
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    o, lse = reference_flash_attention(
        qf, kf, vf, 1.0 / hd ** 0.5, window, True, dropout, seed,
        return_lse=True)
    dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), do.float())
    return o.detach(), lse.detach().reshape(B * H, T), dq, dk, dv


def flash_kernels(q, k, v, do, window, dropout, seed):
    """K1, then K2 and K3 on the saved (o, lse): o, lse, dq, dk, dv."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )

    B, T, H, hd = q.shape
    scale = 1.0 / hd ** 0.5
    o, lse = flash_fwd(q, k, v, scale, window, dropout, seed)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, window, dropout, seed)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, window, dropout,
                           seed)
    return o, lse, dq, dk, dv


def tol_share(got, want, tol, names):
    """({name: max |err|}, the largest share of its tolerance (atol, rtol)
    any element uses) for tensors compared in float32; a check passes while
    the share <= 1."""
    atol, rtol = tol
    errs, share = {}, 0.0
    for name, g, w in zip(names, got, want):
        diff = (g.float() - w.float()).abs()
        errs[name] = float(diff.max())
        share = max(share, float((diff / (atol + rtol * w.float().abs()))
                                 .max()))
    return errs, share


def flash_errors(got, want, dtype):
    """tol_share for o, lse, dq, dk, dv at the flash tolerance of dtype."""
    return tol_share(got, want, FLASH_TOL[dtype],
                     ("o", "lse", "dq", "dk", "dv"))


def phase_flash_kernel(seed):
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        drop_keep,
        kernel_drop_keep,
    )

    rng = np.random.default_rng(seed + 3)
    # the hash: kernels' device function against the plain version, on a
    # grid whose products wrap int32 (large q/k offsets, negative seeds)
    seeds = torch.tensor([0, 1, -1, 12345, -987654321, 2 ** 31 - 1,
                          -2 ** 31, int(rng.integers(-2 ** 31, 2 ** 31))],
                         dtype=torch.int32, device="cuda")
    n_bits = 0
    for q0, k0 in ((0, 0), (2 ** 20 + 3, 2 ** 31 - 300)):
        for rate in (0.1, 0.5):
            got = kernel_drop_keep(seeds, 24, 96, 256, rate, q0, k0)
            bh = torch.arange(24, device="cuda")[:, None, None]
            qp = q0 + torch.arange(96, device="cuda")[None, :, None]
            kp = k0 + torch.arange(256, device="cuda")[None, None, :]
            want = torch.stack([drop_keep(int(s), bh, qp, kp, rate)
                                for s in seeds.tolist()])
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            if bad:
                fail(f"dropout hash: {bad} of {got.numel()} keep bits "
                     f"differ (q0={q0}, k0={k0}, rate={rate})")
            n_bits += got.numel()

    worst, n_cases, worst_share = {}, 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for T in (1024, 333):
                for window in (0, 100):
                    for dropout in (0.0, 0.1):
                        case = flash_case(rng, 2, T, 2, hd, dtype)
                        dseed = int(rng.integers(-2 ** 31, 2 ** 31))
                        got = flash_kernels(*case, window, dropout, dseed)
                        want = flash_plain(*case, window, dropout, dseed)
                        torch.cuda.synchronize()
                        errs, share = flash_errors(got, want, dtype)
                        worst_share = max(worst_share, share)
                        key = str(dtype).replace("torch.", "")
                        for n, e in errs.items():
                            w = worst.setdefault(key, {})
                            w[n] = max(w.get(n, 0.0), e)
                        if not share <= 1.0:
                            fail(f"flash kernels {key} hd={hd} T={T} "
                                 f"window={window} dropout={dropout}: "
                                 f"max|err| {errs} past {FLASH_TOL[dtype]}")
                        n_cases += 1
    # the training path's own shape: GPT-2 heads, bf16, B 8, T 1024
    case = flash_case(rng, 8, 1024, 12, 64, torch.bfloat16)
    errs, share = flash_errors(flash_kernels(*case, 0, 0.0, 0),
                               flash_plain(*case, 0, 0.0, 0), torch.bfloat16)
    if not share <= 1.0:
        fail(f"flash kernels at the training shape: max|err| {errs}")
    emit({"phase": "kernel", "kernel": "flash_attention (fwd, dq, dkv)",
          "cases": n_cases, "max_abs_err": worst,
          "tol_atol_rtol": {str(d).replace("torch.", ""): t
                            for d, t in FLASH_TOL.items()},
          "worst_share_of_tol": worst_share,
          "train_shape_share_of_tol": share,
          "hash_bits_checked": n_bits, "hash_bits_differing": 0,
          "train_shape_max_abs_err": errs})
    return {"flash_fwd": max(errs["o"], errs["lse"]),
            "flash_bwd_dq": errs["dq"],
            "flash_bwd_dkv": max(errs["dk"], errs["dv"])}


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


def profile_step(step, phase="train_profile"):
    """Device time by kernel over one train step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    emit({"phase": phase, "wall_ms_profiled": wall * 1e3,
          "device_ms": total_ms,
          "device_busy_share": total_ms / (wall * 1e3),
          "top_kernels": [{"name": k[:90], "ms": us / 1e3, "calls": n,
                           "share": us / 1e3 / total_ms}
                          for us, k, n in rows[:14]]})


def phase_train(seed, profile=False):
    import tempfile
    import types

    from neuralnetworklibrary_tpu_torch.applications.text import (
        SeqCrossEntropyLoss,
    )
    from neuralnetworklibrary_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )
    from neuralnetworklibrary_tpu_torch.utils.jax_params import (
        load_jax_params,
    )

    t0 = time.perf_counter()
    model = TransformerLM(**GPT2, drop=0.0, flash_attention=True)
    load_jax_params(model, gpt2_params(seed, GPT2))
    setup_s = time.perf_counter() - t0
    V, L, T = GPT2["vocab_size"], GPT2["n_layers"], GPT2["max_len"]
    rng = np.random.default_rng(seed + 4)
    loss_fn = SeqCrossEntropyLoss()

    # (a) f32, B 2: loss and every gradient, flash path against einsum path
    x = torch.from_numpy(rng.integers(0, V, (2, T + 1))).cuda()
    res = []
    for flash in (True, False):
        model.flash_attention = flash
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(x[:, :-1], train=True), x[:, 1:])
        loss.backward()
        res.append((float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    model.flash_attention = True
    model.zero_grad(set_to_none=True)
    loss_err = abs(res[0][0] - res[1][0])
    g_max = max(float(g.abs().max()) for g in res[1][1].values())
    g_err = max(float((res[0][1][n] - g).abs().max())
                for n, g in res[1][1].items())
    del res
    if not (np.isfinite(loss_err) and loss_err <= 1e-4):
        fail(f"f32 flash vs einsum loss: |err| {loss_err} > 1e-4")
    if not g_err <= 1e-3 * g_max:
        fail(f"f32 flash vs einsum grads: max|err| {g_err} > 1e-3 x "
             f"max|grad| {g_max}")

    # (b) bench.py's configuration through the Learner
    B = 8
    xs = rng.integers(0, V, (B, T + 1)).astype(np.int32)
    ds = ArrayDataset(xs[:, :-1], xs[:, 1:])
    data = types.SimpleNamespace(
        target_type="lang_model", bs=B,
        train_dl=DataLoader(ds, B, prefetch=0),
        val_dl=DataLoader(ds, B, prefetch=0))
    batch = data.train_dl.peek()
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", loss_func=loss_fn,
                          seed=seed, compute_dtype="bfloat16")
        learner.init_optimizer(wd=1e-6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
            fn.launches = 0
        losses, step_s = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            losses.append(learner.train1minibatch(batch, 1e-4))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        val_loss = learner.evaluate("val")[0]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches
                    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}
        peak = torch.cuda.max_memory_allocated()
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-4))
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 train losses not finite and falling: {losses}")
    if not np.isfinite(val_loss):
        fail(f"evaluate gave {val_loss}")
    n_eval = len(data.val_dl)
    want = {"flash_fwd": L * (10 + n_eval), "flash_bwd_dq": L * 10,
            "flash_bwd_dkv": L * 10}
    if launches != want:
        fail(f"flash kernel launches {launches} != {want}")
    steady = statistics.median(step_s[1:])
    emit({"phase": "train", "model": "gpt2-124m", "setup_s": setup_s,
          "f32_flash_vs_einsum_loss_abs_err": loss_err,
          "f32_flash_vs_einsum_grad_max_abs_err": g_err,
          "f32_grad_max_abs": g_max, "f32_tol": "loss 1e-4, grads 1e-3 "
                                                 "x max|grad|",
          "dtype": "bfloat16 (autocast)", "B": B, "T": T,
          "optimizer": "Adam2", "lr": 1e-4, "wd": 1e-6, "steps": 10,
          "losses": losses, "val_loss": val_loss,
          "first_step_ms": step_s[0] * 1e3,
          "ms_per_step_median_2_to_10": steady * 1e3,
          "tokens_per_s": B * T / steady,
          "peak_memory_GB": peak / 1e9,
          "eval_batches": n_eval, "kernel_launches": launches})
    return launches


def flash_bound(B, T, H, hd, kind):
    """Least time of one call at this shape: the bytes it must move (each
    input read once, each output written once) over HBM bandwidth, against
    its causal tensor-core flops at the bf16 peak.  Returns (ms, by)."""
    elem = B * T * H * hd * 2             # one bf16 (B, T, H, hd) tensor
    vec = B * H * T * 4                   # one float32 lse / delta row set
    pairs = B * H * T * (T + 1) // 2      # causal (query, key) pairs
    nbytes, flops = {
        "flash_fwd": (4 * elem + vec, 4 * hd * pairs),
        "flash_bwd_dq": (5 * elem + 2 * vec, 6 * hd * pairs),
        "flash_bwd_dkv": (6 * elem + 2 * vec, 8 * hd * pairs)}[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash_timing(seed):
    import torch.nn.functional as F

    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
        reference_flash_attention,
    )

    B, T, H, hd = 8, 1024, 12, 64
    rng = np.random.default_rng(seed + 5)
    q, k, v, do = flash_case(rng, B, T, H, hd, torch.bfloat16)
    scale = 1.0 / hd ** 0.5
    timer = Timer()
    o, lse = flash_fwd(q, k, v, scale)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    ms = {"flash_fwd": timer.ms(lambda: flash_fwd(q, k, v, scale)),
          "flash_bwd_dq": timer.ms(lambda: flash_bwd_dq(
              q, k, v, do, lse, delta, scale)),
          "flash_bwd_dkv": timer.ms(lambda: flash_bwd_dkv(
              q, k, v, do, lse, delta, scale))}

    # the plain version (in bf16, as the port would run it) and, as a
    # yardstick the port never calls, SDPA: forward alone, and the
    # backward alone (dq, dk, dv together) on a retained graph
    def fwd_bwd_ms(fn):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        fwd = timer.ms(lambda: fn(qg, kg, vg))
        out = fn(qg, kg, vg)
        bwd = timer.ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        return fwd, bwd

    plain_fwd, plain_bwd = fwd_bwd_ms(
        lambda a, b, c: reference_flash_attention(a, b, c, scale))
    lib_fwd, lib_bwd = fwd_bwd_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            is_causal=True).transpose(1, 2))
    rows = {}
    for name in ms:
        bound_ms, bound_by = flash_bound(B, T, H, hd, name)
        fwd = name == "flash_fwd"
        rows[name] = {
            "ms": ms[name], "plain_ms": plain_fwd if fwd else plain_bwd,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if fwd else lib_bwd}
        emit({"phase": "timing", "kernel": name, "B": B, "T": T, "H": H,
              "hd": hd, "dtype": "bfloat16", "causal": True, **rows[name],
              "plain": "reference_flash_attention in bf16"
                       + ("" if fwd else ": its backward, dq dk dv together"),
              "library": "F.scaled_dot_product_attention(is_causal=True) "
                         + ("forward" if fwd else
                            "backward, dq dk dv together")
                         + " (yardstick only)",
              "share_of_bound": bound_ms / ms[name]})
    return rows


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


def lstm_case(rng, B, T, H):
    """Random time-major K6/K7 inputs on the card: xp (T, B, 4H) and w
    (H, 4H) in bf16, nonzero h0/c0 and upstream gradients in float32."""
    def normal(scale, *shape):
        return torch.from_numpy(rng.normal(0, scale, shape)
                                .astype(np.float32)).cuda()

    return (normal(0.5, T, B, 4 * H).to(torch.bfloat16),
            normal(1.0 / np.sqrt(H), H, 4 * H).to(torch.bfloat16),
            normal(0.3, B, H), normal(0.3, B, H), normal(1.0, T, B, H),
            normal(1.0, B, H), normal(1.0, B, H))


def lstm_residuals(c0, cs, w):
    """(wT, cprev) as the autograd Function hands them to K7."""
    cprev = torch.cat([c0.to(torch.bfloat16)[None], cs[:-1]]).contiguous()
    return w.t().contiguous(), cprev


def phase_lstm_kernel(seed):
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        kernel_plan,
        lstm_bwd,
        lstm_fwd,
        lstm_scan,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    rng = np.random.default_rng(seed + 6)
    fwd_names = ("ys", "cs", "gates", "hT", "cT")
    bwd_names = ("dgates", "dh0", "dc0")
    worst, worst_share, n_cases = {}, {"fwd": 0.0, "bwd": 0.0}, 0
    main_err = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
    shapes = [(B, T, H) for B in (1, 3, 64) for T in (1, 7, 75)
              for H in (24, 400, 1150)]
    # the kernels' other paths: odd H (per-element staging, 4-byte loads in
    # K7) and more cell items than the threads prefetch for (K7 at B 128,
    # K6 at B 1100)
    shapes += [(3, 7, 25), (128, 7, 1150), (1100, 3, 24)]
    for B, T, H in shapes:
        xp, w, h0, c0, dys, dhT, dcT = lstm_case(rng, B, T, H)
        got = lstm_fwd(xp, w, h0, c0)
        want = reference_lstm_fwd(xp, w, h0, c0)
        wT, cprev = lstm_residuals(c0, want[1], w)
        res = (wT, want[2], want[1], cprev, dys, dhT, dcT)
        bgot = lstm_bwd(*res)
        bwant = reference_lstm_bwd(*res)
        torch.cuda.synchronize()
        for kind, g, wv, names in (("fwd", got, want, fwd_names),
                                   ("bwd", bgot, bwant, bwd_names)):
            errs, share = tol_share(g, wv, LSTM_TOL[kind], names)
            worst_share[kind] = max(worst_share[kind], share)
            for n, e in errs.items():
                worst[n] = max(worst.get(n, 0.0), e)
            if not share <= 1.0:
                fail(f"lstm {kind} B={B} T={T} H={H}: max|err| {errs} "
                     f"past {LSTM_TOL[kind]}")
            if (B, T) == (64, 75) and H in (400, 1150):
                key = "lstm_" + kind
                main_err[key] = max(main_err[key], max(errs.values()))
        n_cases += 1

    # the autograd Function end to end: on the card (K6, K7 and the dw
    # product) against the same Function on the CPU (its plain versions)
    def run(args, grads):
        args = [a.detach().requires_grad_() for a in args]
        outs = lstm_scan(*args)
        torch.autograd.backward(outs, grads)
        return ([o.detach().float().cpu() for o in outs],
                [a.grad.float().cpu() for a in args])

    e2e = []
    for B, T, H in ((3, 7, 24), (64, 75, 1150)):
        for dtype in (torch.float32, torch.bfloat16):
            xp, w, h0, c0, dys, dhT, dcT = lstm_case(rng, B, T, H)
            args = [xp.transpose(0, 1).to(dtype), w.to(dtype), h0.to(dtype),
                    c0.to(dtype)]
            grads = [dys.transpose(0, 1).to(dtype), dhT.to(dtype),
                     dcT.to(dtype)]
            card = run(args, grads)
            cpu = run([a.cpu() for a in args], [g.cpu() for g in grads])
            errs, share = tol_share(card[0], cpu[0], LSTM_TOL["fwd"],
                                    ("ys", "hT", "cT"))
            g_err = {n: float((g - r).abs().max()) / float(r.abs().max())
                     for n, g, r in zip(("dxp", "dw", "dh0", "dc0"), card[1],
                                        cpu[1])}
            if not (share <= 1.0 and max(g_err.values()) <= LSTM_GRAD_TOL):
                fail(f"lstm_scan end to end B={B} T={T} H={H} {dtype}: "
                     f"outputs {errs}, gradient errors / max {g_err}")
            e2e.append({"B": B, "T": T, "H": H,
                        "xp_dtype": str(dtype).replace("torch.", ""),
                        "out_max_abs_err": errs, "out_share_of_tol": share,
                        "grad_err_over_max": g_err})
    emit({"phase": "kernel", "kernel": "lstm_scan (K6 fwd, K7 bwd)",
          "cases": n_cases, "max_abs_err": worst,
          "worst_share_of_tol": worst_share,
          "tol_atol_rtol": LSTM_TOL,
          "main_shape_max_abs_err": main_err,
          "plan_1150": {k: kernel_plan(k, 64, 1150) for k in ("fwd", "bwd")},
          "plan_400": {k: kernel_plan(k, 64, 400) for k in ("fwd", "bwd")},
          "autograd_end_to_end": e2e, "grad_tol_over_max": LSTM_GRAD_TOL})
    return main_err


def lm_corpus(rng, n_tokens, vocab):
    """A random-token TextDataset with bench.py's stoi (bench.py:181-191)."""
    from neuralnetworklibrary_tpu_torch.applications.text import TextDataset

    ds = object.__new__(TextDataset)
    ds.stoi = {f"w{i}": i for i in range(vocab)}
    ds.stoi["_pad_"] = 1
    ds.texts = [rng.integers(0, vocab, 2000).tolist()
                for _ in range(n_tokens // 2000 + 1)]
    ds.num_tokens = sum(len(t) for t in ds.texts)
    ds.labels = [0] * len(ds.texts)
    ds.label_dict = {0: 0}
    return ds


def phase_lm(seed, profile=False):
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.text import (
        LanguageModelAccuracy,
        LanguageModelDataObj,
        LanguageModelNet,
        RegSeqCrossEntropyLoss,
        predict_from_string,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        lstm_bwd,
        lstm_fwd,
    )

    cfg = AWD_LSTM
    B, T, steps = cfg["B"], cfg["bptt"], cfg["steps"]
    rng = np.random.default_rng(seed + 7)
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    data = LanguageModelDataObj(
        lm_corpus(rng, B * (steps * T + T), cfg["vocab"]),
        lm_corpus(rng, B * (cfg["val_windows"] * T + T), cfg["vocab"]),
        None, B, T, seed=seed)
    model = LanguageModelNet.from_dataobj(data)     # 400-1150-3, on cuda
    setup_s = time.perf_counter() - t0
    L = model.num_layers
    loss_fn = RegSeqCrossEntropyLoss(2.0, 1.0)
    batch = data.train_dl.peek()

    # (a) f32 at B 4 from a zero carry: loss and every gradient, kernel
    # path against the float32 step loop
    x = torch.from_numpy(batch.xs[0][:4]).long().cuda()
    y = torch.from_numpy(batch.y[:4]).long().cuda()
    res = []
    for kernel in (None, False):
        model.lstm_kernel = kernel
        model.reset_carry(4)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        res.append((float(loss.detach()), {n: p.grad.clone()
                                           for n, p in model.named_parameters()}))
    # the port's default on the card (the JAX package keeps its kernels
    # behind an opt-in gate): one f32 forward + backward at B 64 on each
    # path, median of 3 after a warm-up, host clock around synchronised
    # work
    xb = torch.from_numpy(batch.xs[0]).long().cuda()
    yb = torch.from_numpy(batch.y).long().cuda()
    path_ms = {}
    for name, kernel in (("kernel", None), ("f32_loop", False)):
        model.lstm_kernel = kernel
        times = []
        for _ in range(4):
            model.reset_carry()
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_fn(model(xb), yb).backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        path_ms[name] = statistics.median(times[1:])
    model.lstm_kernel = None
    model.zero_grad(set_to_none=True)
    model.reset_carry()
    loss_err = abs(res[0][0] - res[1][0])
    g_err = {n: float((res[0][1][n] - g).abs().max() / g.abs().max())
             for n, g in res[1][1].items()}
    del res
    if not loss_err <= LM_LOSS_RTOL * abs(loss.item()):
        fail(f"AWD-LSTM f32 kernel vs loop loss: |err| {loss_err}")
    if not max(g_err.values()) <= LM_GRAD_TOL:
        fail(f"AWD-LSTM f32 kernel vs loop gradients / max: {g_err}")

    # (b) bench_lm's configuration through the Learner; (c) generation
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", loss_func=loss_fn,
                          seed=seed)
        learner.init_optimizer(wd=1e-6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lstm_fwd.launches = lstm_bwd.launches = 0
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(learner.train1minibatch(batch, 1e-3))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        val = learner.evaluate("val", [LanguageModelAccuracy()])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = {"lstm_fwd": lstm_fwd.launches,
                    "lstm_bwd": lstm_bwd.launches}
        peak = torch.cuda.max_memory_allocated()
        prompt = "w5 w6 w7 w8 w9"
        lstm_fwd.launches = 0
        text = predict_from_string(learner, prompt, 16, k=1)
        torch.cuda.synchronize()
        gen_launches = lstm_fwd.launches
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-3),
                         "lm_profile")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"AWD-LSTM train losses not finite and falling: {losses}")
    if not np.isfinite(val[0]):
        fail(f"AWD-LSTM evaluate gave {val}")
    n_eval = len(data.val_dl)
    want = {"lstm_fwd": L * (steps + n_eval), "lstm_bwd": L * steps}
    if launches != want:
        fail(f"lstm kernel launches {launches} != {want}")
    words = text.split()
    n_prompt = len(prompt.split())
    if len(words) != n_prompt + 16 or not all(w in data.stoi for w in words):
        fail(f"predict_from_string gave {text!r}")
    if gen_launches != L * (n_prompt + 16):
        fail(f"predict_from_string launched K6 {gen_launches} times, not "
             f"{L} x {n_prompt + 16}")
    steady = statistics.median(step_s[1:])
    emit({"phase": "lm", "model": "awd-lstm 400-1150-3",
          "vocab": len(data.stoi), "setup_s": setup_s,
          "params": sum(p.numel() for p in model.parameters()),
          "f32_kernel_vs_loop_loss_abs_err": loss_err,
          "f32_kernel_vs_loop_grad_err_over_max": max(g_err.values()),
          "f32_tol": f"loss {LM_LOSS_RTOL} x |loss|, grads {LM_GRAD_TOL} x "
                     f"max|grad| per tensor",
          "f32_fwd_bwd_ms_B64": path_ms,
          "dtype": "float32 (kernels in bf16)", "B": B, "bptt": T,
          "optimizer": "Adam2", "lr": 1e-3, "wd": 1e-6,
          "loss": "RegSeqCrossEntropyLoss(2, 1)", "steps": steps,
          "losses": losses, "val_loss": val[0],
          "val_accuracy": float(val[1][0]), "eval_batches": n_eval,
          "eval_s": eval_s, "first_step_ms": step_s[0] * 1e3,
          "ms_per_step_median_2_to_10": steady * 1e3,
          "tokens_per_s": B * T / steady, "peak_memory_GB": peak / 1e9,
          "kernel_launches": launches,
          "generated": text, "generate_k6_launches": gen_launches})
    return launches


def lstm_bound(B, T, H, kind):
    """Least time of one call: the bytes it must move (each input read
    once, each output written once) over HBM bandwidth, against the step
    products' 2*B*T*H*4H flops at the bf16 tensor-core peak."""
    G = 4 * H
    if kind == "lstm_fwd":   # xp, w, h0, c0 | ys, cs, gates, hT, cT
        nbytes = 2 * T * B * G + 2 * H * G + 8 * B * H \
            + 4 * T * B * H + 2 * T * B * G + 8 * B * H
    else:   # wT, gates, cs, cprev, dys, dhT, dcT | dgates, dh0, dc0
        nbytes = 2 * G * H + 2 * T * B * G + 4 * T * B * H \
            + 4 * T * B * H + 8 * B * H + 4 * T * B * G + 8 * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * B * T * H * G / PEAK_OPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_lstm_timing(seed):
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        lstm_bwd,
        lstm_fwd,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    rng = np.random.default_rng(seed + 8)
    timer = Timer()
    rows = {}
    B, T = AWD_LSTM["B"], AWD_LSTM["bptt"]
    for H, I in ((1150, 1150), (400, 1150)):   # layers 1 and 2 of the LM
        xp, w, h0, c0, dys, dhT, dcT = lstm_case(rng, B, T, H)
        _, cs, gates, _, _ = lstm_fwd(xp, w, h0, c0)
        wT, cprev = lstm_residuals(c0, cs, w)
        res = (wT, gates, cs, cprev, dys, dhT, dcT)
        ms = {"lstm_fwd": timer.ms(lambda: lstm_fwd(xp, w, h0, c0)),
              "lstm_bwd": timer.ms(lambda: lstm_bwd(*res))}
        plain = {"lstm_fwd": timer.ms(lambda: reference_lstm_fwd(
                     xp, w, h0, c0), reps=5),
                 "lstm_bwd": timer.ms(lambda: reference_lstm_bwd(*res),
                                      reps=5)}
        # layer-level yardstick the port never calls: cuDNN's LSTM in bf16
        # on the same layer, which also does the input projection
        lstm = torch.nn.LSTM(I, H, batch_first=True).cuda().to(
            torch.bfloat16)
        x = torch.from_numpy(rng.normal(0, 1, (B, T, I)).astype(
            np.float32)).cuda().to(torch.bfloat16).requires_grad_()
        hc = (h0[None].to(torch.bfloat16), c0[None].to(torch.bfloat16))
        wrt = [x] + list(lstm.parameters())
        with torch.no_grad():
            lib_fwd = timer.ms(lambda: lstm(x, hc))
        out = lstm(x, hc)[0]
        gy = torch.randn_like(out)
        lib_bwd = timer.ms(lambda: torch.autograd.grad(
            out, wrt, gy, retain_graph=True))
        lib_fwd_bwd = timer.ms(lambda: torch.autograd.grad(
            lstm(x, hc)[0], wrt, gy))
        library = {"lstm_fwd": lib_fwd, "lstm_bwd": lib_bwd}
        for name in ms:
            bound_ms, bound_by = lstm_bound(B, T, H, name)
            row = {"ms": ms[name], "plain_ms": plain[name],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library[name]}
            emit({"phase": "timing", "kernel": name, "B": B, "T": T, "H": H,
                  **row, "ms_per_step": ms[name] / T,
                  "plain": ("reference_lstm_fwd" if name == "lstm_fwd"
                            else "reference_lstm_bwd") + " on the card",
                  "library": f"torch.nn.LSTM({I}, {H}) bf16 (cuDNN), "
                             + ("forward" if name == "lstm_fwd" else
                                "backward alone")
                             + "; layer-level yardstick: it also does the "
                               "input projection",
                  "library_fwd_bwd_ms": lib_fwd_bwd,
                  "share_of_bound": bound_ms / ms[name]})
            if H == 1150:   # the main path's widest layers
                rows[name] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel of a serve "
                         "run and of a train step of each model")
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
    flash_err = phase_flash_kernel(args.seed)
    launches = phase_serve(args.seed, args.profile)
    flash_launches = phase_train(args.seed, args.profile)
    lstm_err = phase_lstm_kernel(args.seed)
    lstm_launches = phase_lm(args.seed, args.profile)
    t = phase_timing(args.seed)[0]     # the serving path's own shape
    flash_t = phase_flash_timing(args.seed)
    lstm_t = phase_lstm_timing(args.seed)
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_err, "max_err": main_err,
        "tol": TOL[torch.bfloat16], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]
    for name, row in flash_t.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": flash_launches[name],
            "max_abs_err": flash_err[name],
            "tol": "atol %g + rtol %g" % FLASH_TOL[torch.bfloat16], **row})
    for name, row in lstm_t.items():
        kind = name.split("_")[1]
        kernels.append({
            "name": name, "route": "cuda", "source": LSTM_SOURCE,
            "replaces": LSTM_REPLACES[name],
            "launches": lstm_launches[name], "max_abs_err": lstm_err[name],
            "tol": "atol %g + rtol %g" % LSTM_TOL[kind], **row})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
