"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--profile] [--tile-sweep]

Phases, each printing one JSON line (the first line printed is the card's
name and power limit from nvidia-smi):

- build:  compile every CUDA source of the port with nvcc, in parallel,
          and beside them the LSTM kernels with only their grid barriers
          (the per-step floor of the timing rows); ptxas's registers and
          spills per kernel (a spill in any tensor-core kernel, flash or
          LSTM, fails the run).
- kernel: each kernel against its plain PyTorch version on the card.  The
          paged decode kernel over dtypes, head layouts, block sizes,
          windows, sinks, offset edges and shared table rows, and at the
          serving path's own shape; then where its split of the sequence
          matters: 4,096 positions at B 1 and 3, G 1, 4 and 8, f32, bf16
          and int8 pools, offsets at the shares' edges, windows under one
          share, sinks over many shares, S from 1 to more than the
          chunks, clamped table entries, and two calls bit for bit.
          The flash kernels (forward, dq, dk/dv) over float32 and bf16,
          hd 64 and 128, window 0 and > 0, dropout
          0 and 0.1, at T 1024 and at a T that is no multiple of the tile,
          and at the training path's own shape; and the kernels' dropout
          hash against the plain one bit for bit.  Then the edges of the
          bf16 tensor-core K1, K2 and K3 and of the dbias folded into K3:
          T 127, 129, 200, 1000 (with and without a bias), windows 100 and
          129, B*H 1 and 3, T 114 with a bias, a fully masked batch row,
          dropout; and K3 with dbias twice on the same inputs, which must
          give the same bits.
- adam:   the fused Adam kernel (ops.adam) against the foreach chain
          (core.optim.foreach_adam after the decay's foreach mul and the
          clip's scale) on the same card inputs, at Qwen3-0.6B's trained
          leaves with a clip scale and the norm leaves without weight
          decay, and at the SDAR-30B-A3B cell's stage (2.65 B elements,
          past 2^31) without a clip, each leaf within rtol 1e-5 + atol
          1e-7 of the chain; then at both sizes the kernel, the chain and
          torch._fused_adamw_ (a yardstick the port never calls) timed.
          Every training phase below runs with the kernel's counters from
          0 and a tally of the elements Optimizer.apply trains on the
          card: each must send every such element through the kernel.
- serve:  GPT-2-124M at full width (random weights from --seed, loaded
          through load_jax_params): (a) one f32 paged decode step, kernel
          path against gather path; (b) bf16 PagedServingEngine over 16
          greedy requests.  Paged kernel launches are counted over (b).
- train:  the same GPT-2-124M through the port's Learner with
          flash_attention=True: (a) one f32 forward/backward at B 2, T 1024,
          flash path against the einsum path; (b) the bench.py
          configuration (bf16, B 8, T 1024, Adam2, lr 1e-4, wd 1e-6, drop 0),
          10 train1minibatch steps on one fixed batch, then one evaluate.
          Flash kernel launches, and the padded head's products (one a
          step and one an eval batch), are counted over (b).
- auto_flash: the models' auto rule: the default TransformerLM (hd 32)
          trains a bf16 step through the Learner on the einsum path (no
          flash launch), at hd 64 on the flash path, and so do a
          sinks=True model and a packed one (reset_at); flash_attention=
          True at hd 32 raises.
- lstm:   K6 (LSTM forward scan) and K7 (backward scan) against their
          plain versions on the same bf16 inputs and residuals, B 1, 3, 64
          x T 1, 7, 75 x H 24, 400, 1150 and three shapes for the kernels'
          other paths, nonzero (h0, c0); then where the plan matters, each
          also against the split algorithm of its own plan: a partial last
          cluster, B 65 and 127 (two batch chunks), B 1 at T 1, and every
          cluster size at H 1150 and 400 (one that does not fit is listed);
          K6 and K7 twice, bit for bit; and the autograd Function end to end
          (K6, K7 and the weight-gradient product) on the card against the
          same Function on the CPU, xp in float32 and in bf16; and the
          classifier's long buckets, B 64 at T 1024 and 2048 for H 1150
          and 400.
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
- kernel: the flash kernels' options and the dbias kernel: K1-K4 over
          float32 and bf16, hd 64 and 128, causal and bidirectional, with
          and without a bias, key mask off / ragged / one batch row fully
          masked (bidirectional), dropout 0 and 0.1, at T 512, 114 and (in
          the bidirectional case) 200, and at the T5 path's own two shapes.
          Packed rows: q_start over random documents (a quarter one token
          long) with and without a bias, a window, dropout and a key mask
          over one document's every key, f32 and bf16 (bf16 dq and dk with
          the delta slack of short documents, delta_slack); K1's sink,
          causal, bidirectional and with q_start, with its gradient.  The
          edges phase adds the packed rows' edges and the Qwen3 shape.
- t5:     T5-base (HF t5-base's config.json: d_model 768, 12 heads, d_ff
          3072, 12 + 12 layers, vocab 32,128, relu MLP, RMSNorm, 32
          relative buckets out to 128, tied head scaled by 768**-0.5) with
          random weights from --seed through load_jax_params: (a) one f32
          forward/backward at B 2, flash path against the einsum path, the
          relative-bias tables included (MLPs in gelu for this check); (b)
          bf16, B 16, source 512 (real lengths 384-512, the rest pad),
          target 114, Adam2, lr 1e-4, drop 0.1: 10 train1minibatch steps
          on one fixed batch, then evaluate
          over 2 batches; (c) seq2seq_generate, greedy, 16 tokens for 2
          sources.  K1-K4 launches are counted over (b) and (c).
- vision: the vision Learner path, random weights from --seed, synthetic
          uint8 images: (a) resnet50 and senet154 at B 2, 224 px, one
          train-mode forward and backward on the card against the same
          model on the CPU (float32 logits, and float64 logits and
          gradients, within 1e-3 of their largest entry), and the device
          augmentation's stages on one draw, card against CPU; (b) bench.py's senet154 frozen fine-tune
          (ImageLearner, get_transforms("SideOn", 224), bf16, Adam2,
          freeze(), wd 1e-4, lr 1e-3, 120 classes, B 64): 10 steps on one
          batch, then evaluate('val') over 2 batches with accuracy; the
          body's BatchNorm statistics must move; (c) resnet50 unfrozen
          (bench_resnet50_mfu's learner, B 64, bf16, Adam2) through
          Learner(input_pipeline=) with __graft_entry__.py's augmentation,
          the device warp included, 10 steps, with the augmentation's ms
          per batch; (d) bn_freeze('non_head') for one step at B 8: the
          body's BatchNorm parameters and buffers bit for bit unchanged,
          every head tensor moved.  Losses finite and falling; img/s of
          the median step of 2-10, ms per step, peak memory.
- vit:    ViT-B/16 (google/vit-base-patch16-224's widths, random
          weights): (a) f32 B 2, flash path against einsum path (loss
          1e-4, gradients 1e-3 x max); (b) bf16 B 64, 120 classes, Adam2,
          lr 1e-4, through the Learner with a normalize_batch pipeline,
          10 steps and evaluate over 2 batches.  K1-K3 run bidirectional
          at T 197; their launches over (b) are exact (12 x 10 each, and
          12 x 2 more K1 in the evaluation).
- classifier: the IMDB classifier, ULMFiT stage 2 (examples/imdb.py:
          78-96): AWD-LSTM 400-1150-3, vocab 60,002, attention 100, fc
          (100,), random weights, on 1,920 train and 640 val synthetic
          reviews (lengths log-normal, median 180 tokens, sigma 0.75,
          clipped to [10, 3000]) in the length-bucketed loader (bs 64,
          bpg 10, buckets 64-4096): (a) an LM Learner at the same vocab,
          from_language_model and the encoder transfer, bit for bit; (b)
          float32, eval mode, kernels against the float32 step loop at
          buckets 64 and 512 (loss, logits, encoder output, encoder
          gradients); (c) bf16, Adam2, wd 1e-6, clip 0.4: freeze() and 3
          steps (the encoder unchanged, no K7 launch), unfreeze() and 12
          steps of a new epoch (the longest bucket first) at lr [1e-3,
          3e-3, 1e-2], evaluate('val', [TextClassificationAccuracy(),
          'auc']), predict('val').  K6/K7 launches exact per stage; ms per
          step by bucket, documents/s and non-pad tokens/s (median of
          steps 2-12), peak memory.
- collab: examples/movielens.py on its synthetic table (100k ratings,
          600 users, 9,000 items, val 0.2): CollabFilterNet emb 30, bs
          8192, Adam2, fit_one_cycle(0.01, 2), wd 1e-4; one step's
          gradients and the trained val MSE, card against CPU; a second
          member, the 2-member CollabFilterEnsembleNet against
          combine_preds; rows/s.
- structured: bench.py's bench_structured (200k rows, 20 categorical
          columns of 50 levels, 20 continuous, head [1000, 500, 1], bs
          1024, Adam2, wd 1e-4, lr 1e-3): a train forward and backward,
          card against CPU (output, BatchNorm statistics, gradients); one
          epoch, then evaluate, as structured_rows_per_sec; a 'cat' target
          (5 classes) at B 1024 whose evaluate gives [loss, accuracy].
- detection: bench.py's bench_detection through the port's
          ObjectDetectionLearner, random weights, synthetic images (no
          cv2): (a) retinanet18 at feature 32, B 2, 128 x 192, output convs
          random, a train-mode forward and backward through the SSD loss
          on the card against the CPU (anchors equal; float32 reg, clas
          and loss, float64 also the FPN's and subnets' gradients, within
          1e-3 of max), and decode + NMS on the card against the CPU on
          the same reg / clas (classes, scores and counts equal); (b)
          retinanet50 at feature 256, 20 classes, 64 images of 375 x 500
          (1-5 bright boxes), val 0.25, ARS (512, 1024), granularity 128
          (a 512 x 768 canvas, 73,656 anchors), bf16, B 8, Adam2, wd 1e-4,
          clip 1.0: 10 steps on one batch, evaluate('val') with the SSD
          metrics, predict('val', thresh 0.05, max_boxes 20) with NMS on
          the device (img/s, and the kernel launches of one batch's
          forward, decode + NMS and NMS alone, with the NMS sweeps), and
          at thresh 0, where every top-k candidate enters the NMS;
          compute_mAP and coco_pascal_eval on the thresh-0 predictions
          (its C++ helper built with g++ here); then the canvas as the
          device cache: 10 cached train steps and cached predicts.
- qwen3:  Qwen3-0.6B (HF Qwen/Qwen3-0.6B config.json) with random
          weights through load_qwen3, on packed rows of synthetic
          documents (reset_at = eos, pad a dedicated id): (a) 2 layers at
          full width, f32, flash path against einsum path on two rows
          (loss 1e-4, gradients 1e-3 x max), and three documents alone
          against their place in a row; (b) the full 28 layers, bf16, B 4
          x T 4096, Adam2, PackedSeqCrossEntropyLoss, through the Learner
          over ArrayDataset / DataLoader: 10 steps on successive batches,
          evaluate over 2, exact K1-K3 launches (28 a forward, 28 a
          backward), tokens/s and non-pad tokens/s, peak memory; (c)
          fused_ce=True: the chunked CE against the materialised one on a
          batch, then 3 steps with FusedSeqCrossEntropyLoss and their peak.
- timing: each call's device time by CUDA events, with the L2 flushed
          and the card held by a spin kernel while the host enqueues the
          call (Timer); the median and the spread (min, max) of the reps.
          Library yardsticks: SDPA with its backend pinned, cuDNN's LSTM;
          for SDPA's backward also the events without the spin and the
          profiler's mean.  K1-K4 also at the T5 encoder's shape.  K5 at
          six rows (K5_TIMING): the serving shape at offset 511, B 32 at
          1023, B 1 at 1023, the serve run's offsets, Llama-3-8B's heads
          at 4,096 positions, and int8 pools; its yardstick is SDPA on
          the strip cut to the live positions with the kv heads shared,
          and beside it SDPA on the whole masked strip.  K6/K7 at the LM's
          widths with their plan and the same launch with only its grid
          barriers (the per-step floor), and at the classifier's B 64,
          T 512 (IMDB's common bucket).  K1-K3 also at the ViT-B/16
          shape (B 64, H 12, T 197, hd 64, bidirectional), with SDPA's
          cuDNN and flash backends pinned as at the GPT-2 shape.  The
          flash kernel phase also holds K1-K3 at that shape, bf16 and f32.
          K1-K3 at the Qwen3 path's packed rows (B 4, T 4096, H 16, hd
          128, their q_start; bound from the attended pairs), beside the
          same kernels over the whole causal triangle, with SDPA's
          memory-efficient backend and the block-diagonal causal mask.

--profile adds torch.profiler breakdowns of one more serve run and of one
more train step of each model (senet154, ViT-B/16, Qwen3-0.6B, the
classifier at
bucket 512 with K6 + K7's share, collab, structured and RetinaNet
included, and of one detection predict): device
time by kernel (for the serve run also every K5 kernel by name), the
copy and NCHW/NHWC transpose kernels, and, for the train steps, the host
ops with the most host time of their own.  --tile-sweep adds K5 at S
in {1, chosen, 2 x chosen} with its warps and half of them, with its
staging or its arithmetic removed, and under a read flush, K1 and K2 built
with other key-tile widths and ring depths, and K3 with other query-tile
widths, consumer warpgroups and ring depths, timed at hd 64 and 128 (the
measurement behind the shipped constants); and K6/K7 at every cluster size
and two ring depths, and built without the multiply, without the staging
and with only the grid barriers.

Then a "kernels" line with every ported kernel, and last the line
{"ok": true, "device": {...}}.  Any failure exits non-zero; no phase
catches an error and carries on.  Without a CUDA device it exits 2 before
printing anything else.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "neuralnetworklibrary_tpu/ops/paged_attention.py:68"
SOURCE = "neuralnetworklibrary_tpu_torch/csrc/paged_attention.cu"
K5_DESIGN = ("split-sequence (flash-decoding), SIMT f32: grid (Hkv x head "
             "groups, B, S), S from shapes and occupancy on the host (one "
             "wave); a cp.async ring of 32-position chunks in 16-byte "
             "pieces, block-table entries read a stage ahead; R lanes per "
             "row, shuffle dots for all heads of the kv head, 4 warps (8 "
             "for 4-8 heads); the last block of each (slot, head group), by "
             "an integer ticket, merges the S partials in split order "
             "(paged_split_kernel, one launch)")
# K5's split cases: (label, H, Hkv, hd, pool dtype, q dtype), each at MB
# 128, bs 32 (4,096 positions), B 1 and 3
K5_SPLIT_CONFIGS = (
    ("g1_bf16", 12, 12, 64, torch.bfloat16, torch.bfloat16),
    ("g1_f32", 12, 12, 64, torch.float32, torch.float32),
    ("g4_bf16", 32, 8, 128, torch.bfloat16, torch.bfloat16),
    ("g8_bf16", 64, 8, 128, torch.bfloat16, torch.bfloat16),
    ("g8_f32", 64, 8, 128, torch.float32, torch.float32),
    ("int8_f32q", 12, 12, 64, torch.int8, torch.float32),
    ("int8_g4_f32q", 32, 8, 128, torch.int8, torch.float32),
    ("int8_bf16q", 32, 8, 128, torch.int8, torch.bfloat16))
# K5's timing rows: (label, B, H, Hkv, hd, MB, pool dtype, offset; None:
# drawn in 32-320, as phase_serve's requests reach them), all at bs 32
# with bf16 q
K5_TIMING = (
    ("slice", 8, 12, 12, 64, 32, torch.bfloat16, 511),
    ("long_context", 32, 12, 12, 64, 32, torch.bfloat16, 1023),
    ("b1", 1, 12, 12, 64, 32, torch.bfloat16, 1023),
    ("serve_mix", 8, 12, 12, 64, 32, torch.bfloat16, None),
    ("gqa", 16, 32, 8, 128, 128, torch.bfloat16, 4095),
    ("int8", 8, 12, 12, 64, 32, torch.int8, 511))
K5_SWEEP = ("slice", "b1", "gqa")   # and long_context for the ablations
ADAM_SOURCE = "neuralnetworklibrary_tpu_torch/csrc/adam.cu"
ADAM_REPLACES = ("no TPU kernel: XLA fuses the JAX package's Adam step "
                 "(neuralnetworklibrary_tpu/core/optim.py:207)")
ADAM_DESIGN = ("multi-tensor, one pass: a table of <= 80 tensors by value "
               "(p, g, m, v, numel, first unit, decay), units of 8,192 "
               "elements walked by a grid-stride wave, 16-byte vectors "
               "where all four pointers align, 64-bit offsets; 28 bytes an "
               "element, no temporaries, one launch per (group, step "
               "count) table")
# the kernel against the foreach chain, elementwise |got - want| <= atol +
# rtol*|want| (test_optimizer_matches_jax's): both compute in float32 in
# one order, and differ where nvcc contracts a multiply-add into an fma
ADAM_TOL = (1e-5, 1e-7)
# Adam2 at the cells' lr 3e-4 and wd 0.1, a step count of 3
ADAM_STEP = dict(lr=3e-4, wd=0.1, b1=0.9, b2=0.99, t=3, eps=1e-8)
FLASH_SOURCE = "neuralnetworklibrary_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "neuralnetworklibrary_tpu/ops/flash_attention.py:119",
    "flash_bwd_dq": "neuralnetworklibrary_tpu/ops/flash_attention.py:275",
    "flash_bwd_dkv": "neuralnetworklibrary_tpu/ops/flash_attention.py:338",
    "flash_bwd_dbias": "neuralnetworklibrary_tpu/ops/flash_attention.py:419"}
FLASH_KERNELS = tuple(FLASH_REPLACES)
# what computes each kernel: K1-K3 run on the tensor cores for bf16 (the
# main paths' type) and on the CUDA cores in f32 for float32; bf16 dbias
# comes out of K3's pass (its dS per batch row) and a batch-sum kernel
FLASH_DESIGN = {"flash_fwd": "wgmma+TMA, bf16 (SIMT f32 for float32)",
                "flash_bwd_dq": "wgmma+TMA, bf16 (SIMT f32 for float32)",
                "flash_bwd_dkv": "wgmma+TMA, bf16 (SIMT f32 for float32)",
                "flash_bwd_dbias": "bf16: folded into flash_bwd_dkv_tc_kernel"
                                   "'s pass (dS per batch row to a scratch) "
                                   "+ flash_dbias_reduce_kernel (sum over b, "
                                   "fixed order); SIMT f32 for float32"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (hopper-kernels guide, table 1)
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K5's split cases, besides TOL: elementwise |got - want| <= atol +
# rtol*|want| against the plain version and the split algorithm, both in
# float32 on the same inputs.  float32 q: only the order of the sums
# differs.  bf16 q: the kernel computes in float32 and rounds the output
# to bf16, at most 2**-8 of the value (the rtol is twice that); the atol
# covers the order of the float32 sums.  An output over 4,096 live
# positions of unit-normal rows is ~0.03, so TOL alone would let a dropped
# or mis-scaled share pass; this limit holds such a case to ~a tenth of it.
K5_SPLIT_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2 ** -7)}
# flash kernels, elementwise |got - want| <= atol + rtol*|want| against the
# plain version in float32 on the same inputs.  float32: only the order of
# the sums differs.  bf16: the kernels compute in float32 from bf16 inputs
# and round o, dq, dk, dv to bf16 (relative 2**-9, the rtol's share), and
# the backward takes delta = rowsum(dO * O) from the rounded o, as the JAX
# package does.  With unit-normal inputs that shifts delta by ~0.02 per
# row at hd 64-128 (~0.1 at the worst of 4096 rows), and dq, dk by
# sm_scale * that * |sum_c P K| ~ 0.013: the atol's share, with 2x margin.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# K4's dbias, elementwise |got - want| <= a * max|want| + rtol * |want| +
# slack: it sums B tiles of dS = P * (dP - delta).  float32: only the order
# of the sums differs (each dS term ~1e-7 relative), slack 0.  bf16: the
# kernels take delta from the bf16-rounded o (as above), off by at most
# c = 2**-9 * sum_d |dO_d| |o_d| in a row, which moves each dS term by
# P * c: the slack is twice sum_b P_b * c_b for each entry (dbias_slack).
DBIAS_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 1e-3)}
GPT2 = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12,
            max_len=1024, norm_eps=1e-5)
# Qwen3-0.6B (HF Qwen/Qwen3-0.6B config.json): hidden 1024, 28 layers, 16
# heads of 128 (16 x 128 = 2048 != 1024) over 8 kv heads, SwiGLU 3072,
# RMSNorm eps 1e-6, rope_theta 1e6, q/k norms, tied embeddings, no biases
QWEN3 = dict(vocab_size=151936, d_model=1024, n_layers=28, n_heads=16,
             n_kv_heads=8, head_dim=128, d_ff=3072, norm_eps=1e-6,
             rope_base=1e6)
# its pretraining traffic: B 4 rows of T 4096 packed with synthetic
# documents (log-normal lengths, median 512, sigma 1.0, clipped to [8,
# 4095]); eos <|endoftext|> (151643, Qwen's document separator), pad a
# dedicated id (151935, an unused slot of the padded vocabulary); Adam2 at
# lr 3e-4, wd 0.1; 10 steps, evaluate over 2 batches; 3 fused-CE steps
QWEN3_TRAFFIC = dict(B=4, T=4096, median=512, sigma=1.0, min_len=8,
                     max_len=4095, eos=151643, pad=151935, lr=3e-4, wd=0.1,
                     steps=10, eval_batches=2, fused_steps=3)
LSTM_SOURCE = "neuralnetworklibrary_tpu_torch/csrc/lstm_scan.cu"
LSTM_REPLACES = {"lstm_fwd": "neuralnetworklibrary_tpu/ops/pallas_lstm.py:49",
                 "lstm_bwd": "neuralnetworklibrary_tpu/ops/pallas_lstm.py:138"}
LSTM_DESIGN = ("mma.sync bf16 on the tensor cores, cp.async ring of 64-column "
               "tiles, the step product split over the k index inside a "
               "thread-block cluster and summed over distributed shared "
               "memory in a fixed order; a persistent grid of clusters, one "
               "grid barrier per step")
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
# T5-base v1.0 (HF t5-base config.json; Raffel et al. 2020 "Base"), built
# as utils/t5_convert.py's load_t5 builds it
T5 = dict(vocab_size=32128, pad_token=0, d_model=768, n_heads=12,
          enc_layers=12, dec_layers=12, d_ff=3072, max_src_len=512,
          max_len=512, drop=0.1, pos_embedding="relative", rel_buckets=32,
          rel_max_dist=128, norm="rmsnorm", norm_eps=1e-6, mlp_act="relu",
          tied_decoder=True, logit_scale=768 ** -0.5)
# the traffic: T5's input length, its span-corruption target at inputs 512
# (113 tokens + eos), 16 rows (T5 trains at 128: cut to one card's smoke)
T5_TRAFFIC = dict(B=16, src=512, src_min=384, tgt=113, steps=10,
                  eval_batches=2, gen_tokens=16)
# the T5 model at f32, flash path against the einsum path: the loss within
# 1e-4 relative, each parameter's gradient within 1e-3 of its largest entry
T5_LOSS_RTOL, T5_GRAD_TOL = 1e-4, 1e-3
# the vision runs: bench.py's senet154 frozen fine-tune (build_learner
# :93-111; Dogbreed's 120 classes at 224 px, B 64) and resnet50 unfrozen
# (bench_resnet50_mfu :337-351), on synthetic uint8 images from --seed
VISION = dict(B=64, px=224, classes=120, steps=10, eval_batches=2)
# ViT-B/16 at HF google/vit-base-patch16-224's config.json widths
VIT_B16 = dict(image_size=224, patch=16, d_model=768, n_heads=12,
               n_layers=12, d_ff=3072, norm_eps=1e-12, exact_gelu=True)
# its attention: (224/16)**2 + 1 tokens, bidirectional, no bias, no mask
VIT_SHAPE = dict(B=64, T=197, H=12, hd=64)
# resnet50 and senet154 at B 2, card against CPU (TF32 off): the float32
# logits, and the float64 logits and gradients, within 1e-3 of their
# largest entry.  float32 gradients are not compared: through the
# train-mode BatchNorms of B 2 they lose ~2e-2 of their largest entry
# against float64 on one device alone (resnet50 at 64 px on the CPU:
# 0.85 of 50.7), so two devices' float32 gradients differ by that much
# whatever the code; float64 holds the two devices' arithmetic equal.
VISION_CPU_TOL = 1e-3
# the augmentation stages, card against CPU on one draw.  The warp's
# float32 source coordinates reach ~230 px, where one ulp is 2**-16; the
# card contracts A @ p + b into fmas, the CPU does not, so x and y may
# each round ~2 ulps apart, and a bilinear sample moves by that times the
# step between neighbouring pixels (up to 1 on noise images): 4 * 2**-16
# on the [0, 1] image, over the smallest imagenet std after normalizing
AUG_TOL = 4 * 2 ** -16 / 0.224
# the IMDB classifier, ULMFiT stage 2 (examples/imdb.py:78-96): the
# AWD-LSTM 400-1150-3 at numericalize's max_vocab 60,000 + specials, 2
# classes, attention 100, fc (100,), bs 64, bpg 10; reviews log-normal
# around IMDB's median of ~180 tokens (sigma 0.75), clipped to [10, 3000]
IMDB_CLF = dict(vocab=60002, classes=2, attn=100, fc=(100,), B=64, bpg=10,
                n_train=1920, n_val=640, median=180, sigma=0.75, min_len=10,
                max_len=3000, frozen_steps=3, frozen_lr=1e-2,
                unfrozen_steps=12, lrs=[1e-3, 3e-3, 1e-2], wd=1e-6,
                clip=0.4)
CLF_CHECK_T = (64, 512)      # buckets of the f32 kernel-vs-loop check
CLF_LONG_T = (1024, 2048)    # K6/K7 against their plain versions at B 64
CLF_TIMING_T = 512           # K6/K7 timed at B 64 (IMDB's common bucket)
# MovieLens as examples/movielens.py runs it on its synthetic table
MOVIELENS = dict(n=100_000, users=600, items=9000, emb=30, bs=8192,
                 lr=0.01, epochs=2, wd=1e-4, val_frac=0.2)
# Rossmann-shaped, as bench.py's bench_structured (:458-506); the 'cat'
# variant bins y into 5 quantile classes
ROSSMANN = dict(n=200_000, n_cat=20, levels=50, n_cont=20,
                head=[1000, 500, 1], bs=1024, lr=1e-3, wd=1e-4, val_frac=0.1,
                classes=5, cat_steps=10)
# bench.py's bench_detection (:508-620): retinanet50 at feature 256 on 64
# synthetic Pascal-shaped 375 x 500 images of 1-5 bright boxes in 20
# classes, val 0.25, scaled under ARS (512, 1024) and padded to granularity
# 128 (a 512 x 768 canvas), B 8, Adam2, wd 1e-4, clip 1.0, lr 1e-4
DETECTION = dict(n=64, hw=(375, 500), classes=20, val_frac=0.25,
                 ars=(512, 1024), gran=128, B=8, lr=1e-4, wd=1e-4, clip=1.0,
                 steps=10)
# the detection model card against CPU: retinanet18 at feature 32, B 2,
# 128 x 192.  float32 reg, clas and the SSD loss, and in float64 also the
# FPN's and subnets' gradients, within 1e-3 of their largest entry (as
# VISION_CPU_TOL: through train-mode BatchNorms of B 2 float32 gradients
# move by more than that on one device alone)
DET_CHECK = dict(backbone="resnet18", feature=32, classes=20, B=2,
                 hw=(128, 192))
DET_CPU_TOL = 1e-3
# collab and structured, card against CPU in float32 (TF32 off): the same
# sums in other orders (cuBLAS's kernels, the embedding gradients'
# atomic adds), each result within 1e-4 of its largest entry
CARD_CPU_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------- inputs


def paged_case(rng, B, H, Hkv, hd, bs, MB, pool_dtype, q_dtype, offsets,
               share=False, N=None, on_card=False):
    """Random q, pools, table and offsets on the card; row 0 is trash.
    on_card: draw q, the pools and scales on the card from a generator
    seeded by ``rng`` (large pools; the same values for the same seed)."""
    N = N or B * MB + 1
    q = torch.from_numpy(rng.normal(0, 1, (B, H, hd)).astype(np.float32))
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(
            int(rng.integers(0, 2 ** 31)))
        if pool_dtype == torch.int8:
            pk, pv = (torch.randint(-127, 128, (N, bs, Hkv, hd),
                                    generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in range(2))
            sk, sv = (torch.empty(N, bs, Hkv, device="cuda")
                      .uniform_(0.001, 0.02, generator=gen)
                      for _ in range(2))
        else:
            pk, pv = (torch.randn(N, bs, Hkv, hd, generator=gen,
                                  device="cuda") for _ in range(2))
            sk = sv = None
    elif pool_dtype == torch.int8:
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
    """Device time of one call: CUDA events around it, after a 512 MB write
    (so the call finds its inputs outside the 50 MB L2, as a decode step
    does after the other layers' weights have passed through) and then a
    spin kernel of ~5 ms, during which the host enqueues the whole call,
    autograd's work included; so the events bracket only the call's work
    on the card.  ``stats`` gives the median and the spread (min, max) of
    the reps; ``spin=False`` drops the spin (the host's time can then land
    inside the window, as it did for SDPA's backward before).
    ``profiled_ms`` is a cross-check: the mean over the reps of the device
    time torch.profiler sums over their kernels, in one profiler run, without
    the flush.  ``flush="read"`` reads the 512 MB instead of writing it, so
    the timed call finds no dirty lines to write back."""

    SPIN_CYCLES = 10_000_000     # ~5 ms at 1.98 GHz

    def __init__(self, flush="write"):
        self.flush = torch.empty(128 << 20, dtype=torch.int32, device="cuda")
        self.flush_op = {"write": self.flush.zero_,
                         "read": self.flush.sum}[flush]

    def stats(self, fn, reps=30, warmup=3, spin=True):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_op()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return spread([s.elapsed_time(e) for s, e in pairs])

    def profiled_ms(self, fn, reps=10):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(device_us(evt) for evt in prof.key_averages()
                    if evt.device_type == torch.autograd.DeviceType.CUDA)
        return total / 1e3 / reps if total > 0 else None


def spread(times):
    """{"ms": median, "min": ..., "max": ...} of a list of ms."""
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times)}


def device_us(evt):
    """Device time of one key_averages() row of a kernel, in us."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0))


TIMED_KEYS = ("ms", "ms_spread", "plain_ms", "plain_ms_spread", "bound_ms",
              "bound_by", "library_ms", "library_ms_spread")


def timed_row(kernel, plain, library, bound):
    """A timing row from the stats of the kernel, its plain version and the
    library call (None where no one call computes the function), and
    (bound_ms, bound_by)."""
    return {"ms": kernel["ms"], "ms_spread": [kernel["min"], kernel["max"]],
            "plain_ms": plain["ms"],
            "plain_ms_spread": [plain["min"], plain["max"]],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None if library is None else library["ms"],
            "library_ms_spread": None if library is None
            else [library["min"], library["max"]]}


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


def kernel_name(mangled):
    """name<template arguments> of an Itanium-mangled kernel name (its last
    nested name; ints, bools, float and bf16 arguments)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    s, p, name = mangled, m.end(), None
    while p < len(s) and s[p].isdigit():
        n = re.match(r"\d+", s[p:]).group()
        name = s[p + len(n):p + len(n) + int(n)]
        p += len(n) + int(n)
    if name is None:
        return mangled
    args = []
    if p < len(s) and s[p] == "I":
        p += 1
        while p < len(s) and s[p] != "E":
            if s.startswith(("Li", "Lb"), p):
                end = s.index("E", p)
                v = s[p + 2:end]
                args.append(v if s[p + 1] == "i"
                            else "true" if v == "1" else "false")
                p = end + 1
            elif s[p].isdigit():
                n = re.match(r"\d+", s[p:]).group()
                ident = s[p + len(n):p + len(n) + int(n)]
                args.append("bf16" if ident == "__nv_bfloat16" else ident)
                p += len(n) + int(n)
            elif re.match(r"S[0-9A-Z]*_", s[p:]):
                # a substitution: here, the type named just before
                args.append(args[-1] if args else "?")
                p += re.match(r"S[0-9A-Z]*_", s[p:]).end()
            else:
                args.append({"f": "f32", "a": "i8"}.get(s[p], s[p]))
                p += 1
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas=-v output."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def lstm_variant_start(label, **constants):
    """Start building an edited copy of csrc/lstm_scan.cu with the given
    constants (kAblate: 1 no multiply, 2 no staging, 3 only the grid
    barriers; kTrace 1: phase stamps) into _build/lstm_<label>/; returns
    (label, directory, process)."""
    import shutil

    from neuralnetworklibrary_tpu_torch.kernels import build

    d = build.BUILD / f"lstm_{label}"
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(build.CSRC / "hopper.cuh", d / "hopper.cuh")
    src = (build.CSRC / "lstm_scan.cu").read_text()
    for name, value in constants.items():
        line = f"constexpr int {name} = 0;"
        if src.count(line) != 1:
            fail(f"lstm variant: {line!r} is not in the source once")
        src = src.replace(line, f"constexpr int {name} = {value};")
    (d / "lstm_scan.cu").write_text(src)
    return label, d, subprocess.Popen(
        [build.nvcc(), *build.FLAGS, "-o", str(d / "lib.so"),
         str(d / "lstm_scan.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def lstm_variant_load(started):
    """Wait for a variant of lstm_variant_start; its loaded library with the
    wrapper's signatures, and its ptxas report."""
    import ctypes

    from neuralnetworklibrary_tpu_torch.kernels import build
    from neuralnetworklibrary_tpu_torch.ops import lstm_scan as ls

    label, d, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"lstm variant {label} did not build:\n{log[-3000:]}")
    lib = build.declare(ctypes.CDLL(str(d / "lib.so")), ls.SIGNATURES)
    return lib, ptxas_report(log)


# the library of K6/K7 with only their grid barriers (the per-step floor),
# built beside the sources in phase_build
LSTM_FLOOR = {}


def phase_build():
    from neuralnetworklibrary_tpu_torch.kernels import build

    t0 = time.perf_counter()
    floor = lstm_variant_start("barriers", kAblate=3)
    res = build.build()
    LSTM_FLOOR["lib"], floor_ptxas = lstm_variant_load(floor)
    ptxas = {n: ptxas_report(r["log"]) for n, r in res.items()}
    spilled = {k: v for n in ("flash_attention", "lstm_scan")
               for k, v in ptxas[n].items()
               if "_tc_kernel" in k and (v.get("spill_stores")
                                         or v.get("spill_loads"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {n: r["seconds"] for n, r in res.items()},
          "ptxas": ptxas, "lstm_barriers_only_ptxas": floor_ptxas})
    if spilled:
        fail(f"the tensor-core kernels spill registers: {spilled}")


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
    paged_split_checks(rng)
    return main_err


def split_boundaries(S, n_chunks):
    """First chunks of shares 1..S-1 when n_chunks chunks are cut in S."""
    return sorted({s * n_chunks // S for s in range(1, S)})


def paged_split_checks(rng):
    """K5 where its shares matter, each call held against the plain version
    and the split algorithm in plain PyTorch at TOL and K5_SPLIT_TOL (the
    table clamped for the plain version): for each of K5_SPLIT_CONFIGS, B 1
    and 3 at MB 128, bs 32, with the wrapper's S and with S 1, 2, 7 and
    129 (more shares than chunks): offsets 0, each boundary of the chosen
    S's shares of the full range +-1, and the last position; windows 1, bs
    + 3 and 40 (under one share, so most shares are empty); a sink with
    many shares; table entries out of range (clamped); and two calls on
    the same inputs, which must give the same bits."""
    from neuralnetworklibrary_tpu_torch.ops import paged_attention as pa

    bs, MB = 32, 128
    npos = MB * bs
    worst, worst_split, worst_share, splits_used = {}, {}, {}, {}
    n_cases, identical = 0, True
    for label, H, Hkv, hd, pdt, qdt in K5_SPLIT_CONFIGS:
        base = paged_case(rng, 3, H, Hkv, hd, bs, MB, pdt, qdt,
                          [npos - 1] * 3, on_card=True)
        N = base["pool_k"].shape[0]
        chosen = {B: pa.splits_for(base["q"][:B], base["pool_k"],
                                   base["block_table"][:B]) for B in (1, 3)}
        splits_used[label] = {f"B{B}": S for B, S in chosen.items()}

        def run(offs, window=0, sink=None, splits=None, wild=False):
            nonlocal n_cases
            B = len(offs)
            tbl = base["block_table"][:B].clone()
            for b, o in enumerate(offs):
                tbl[b, min(o, npos - 1) // bs + 1:] = 0
            if wild:   # out of range both ways, inside the live ranges
                tbl[:, 0] = -5
                tbl[:, MB // 3] = N + 9
            case = dict(base, q=base["q"][:B].contiguous(),
                        block_table=tbl,
                        offsets=torch.tensor(offs, dtype=torch.int32,
                                             device="cuda"))
            S = splits or chosen[B]
            kw = dict(window=window, sink=sink)
            got = (pa._launch(**case, splits=S, **kw) if splits
                   else pa.paged_attention(**case, **kw))
            ref = as_f32(case)
            want_split = pa.split_paged_attention_reference(**ref, **kw,
                                                            splits=S)
            ref["block_table"] = tbl.clamp(0, N - 1)
            want = pa.reference_paged_attention(**ref, **kw)
            err = float((got.float() - want).abs().max())
            worst[label] = max(worst.get(label, 0.0), err)
            worst_split[label] = max(
                worst_split.get(label, 0.0),
                float((got.float() - want_split.float()).abs().max()))
            atol, rtol = K5_SPLIT_TOL[qdt]
            used = max(float(((got.float() - w.float()).abs()
                              / (atol + rtol * w.float().abs())).max())
                       for w in (want, want_split))
            worst_share[label] = max(worst_share.get(label, 0.0), used)
            if not (err <= TOL[qdt] and used <= 1.0):
                fail(f"paged_attention split case {label} offsets {offs} "
                     f"window {window} sink {sink is not None} S {S} wild "
                     f"{wild}: max|err| {err} (TOL {TOL[qdt]}), "
                     f"{used:.3g} of atol {atol} + rtol {rtol}*|want|")
            n_cases += 1
            return got

        for B in (3, 1):
            edges = [0, npos - 1]
            for cb in split_boundaries(chosen[B], MB * bs // pa.CHUNK):
                edges += [cb * pa.CHUNK - 1, cb * pa.CHUNK,
                          cb * pa.CHUNK + 1]
            if B == 1:
                edges = edges[:5] + edges[-3:]
            edges += [int(x) for x in rng.integers(0, npos, -len(edges) % B)]
            for i in range(0, len(edges), B):
                run(edges[i:i + B])
        mixed = [npos - 1, npos // 2 - 48, 100]
        for window in (1, bs + 3, 40):
            run(mixed, window=window)
            run([npos - 1], window=window)
        sink = torch.from_numpy(rng.normal(0, 1, H).astype(np.float32)).cuda()
        run([npos - 1], sink=sink)
        run([npos // 3], sink=sink, window=40)
        run(mixed, sink=sink, splits=npos // pa.CHUNK)
        for S in (1, 2, 7, npos // pa.CHUNK + 1):
            run([int(x) for x in rng.integers(0, npos, 3)], splits=S)
        run([npos - 1, npos * 3 // 4, npos + 100], wild=True)
        offs = [int(x) for x in rng.integers(0, npos, 3)]
        a, b = run(offs), run(offs)
        identical &= bool(torch.equal(a, b))
    torch.cuda.synchronize()
    emit({"phase": "kernel", "kernel": "paged_attention_splits",
          "cases": n_cases, "bs": bs, "MB": MB, "splits": splits_used,
          "max_abs_err": worst, "tol": {"float32 q": TOL[torch.float32],
                                        "bfloat16 q": TOL[torch.bfloat16]},
          "max_abs_err_vs_split_reference": worst_split,
          "elementwise_tol": {str(k).replace("torch.", "") + " q": v
                              for k, v in K5_SPLIT_TOL.items()},
          "worst_share_of_elementwise_tol": worst_share,
          "two_calls_bit_identical": identical})
    if not identical:
        fail("two paged_attention calls on the same inputs differ")


def flash_case(rng, B, T, H, hd, dtype):
    """Random q, k, v, do (B, T, H, hd) on the card in ``dtype``."""
    return [torch.from_numpy(rng.standard_normal((B, T, H, hd),
                                                 dtype=np.float32))
            .to("cuda", dtype) for _ in range(4)]


def flash_plain(q, k, v, do, window, dropout, seed, causal=True, bias=None,
                kv_mask=None, q_start=None):
    """The plain version in float32 on the same inputs: o, lse (B*H, T),
    dq, dk, dv, and dbias when there is a bias."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        reference_flash_attention,
    )

    B, T, H, hd = q.shape
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    wrt = [qf, kf, vf]
    if bias is not None:
        bias = bias.detach().clone().requires_grad_()
        wrt.append(bias)
    o, lse = reference_flash_attention(
        qf, kf, vf, 1.0 / hd ** 0.5, window, causal, dropout, seed,
        bias=bias, kv_mask=kv_mask, q_start=q_start, return_lse=True)
    grads = torch.autograd.grad(o, wrt, do.float())
    return (o.detach(), lse.detach().reshape(B * H, T)) + tuple(grads)


def flash_kernels(q, k, v, do, window, dropout, seed, causal=True,
                  bias=None, kv_mask=None, q_start=None):
    """K1, then K2 and K3 on the saved (o, lse): o, lse, dq, dk, dv; with
    a bias K3 runs twice, alone and with dbias (K4 folded into its pass),
    and the two calls' dk and dv must agree bit for bit: o, lse, dq, dk,
    dv, dbias."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_dbias,
        flash_bwd_dq,
        flash_fwd,
    )

    B, T, H, hd = q.shape
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=causal, bias=bias, kvm=additive_mask(kv_mask),
              qs=q_start)
    o, lse = flash_fwd(q, k, v, scale, window, dropout, seed, **kw)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    args = (q, k, v, do, lse, delta, scale, window, dropout, seed)
    dk, dv = flash_bwd_dkv(*args, **kw)
    out = (o, lse, flash_bwd_dq(*args, **kw), dk, dv)
    if bias is not None:
        dk2, dv2, dbias = flash_bwd_dkv_dbias(*args, **kw)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            fail(f"K3 with dbias gave other dk, dv than K3 alone (B={B} "
                 f"T={T} H={H} hd={hd} causal={causal} dropout={dropout})")
        out += (dbias,)
    return out


def additive_mask(kv_mask):
    """The (B, T) bool key mask as the kernels take it: float32 0 / -1e30."""
    if kv_mask is None:
        return None
    return torch.zeros(kv_mask.shape, device=kv_mask.device).masked_fill_(
        ~kv_mask, -1e30)


def tol_share(got, want, tol, names, slack=None):
    """({name: max |err|}, the largest share of its tolerance (atol, rtol),
    plus the elementwise ``slack[name]`` where given, that any element
    uses) for tensors compared in float32; a check passes while the share
    <= 1."""
    atol, rtol = tol
    errs, share = {}, 0.0
    for name, g, w in zip(names, got, want):
        diff = (g.float() - w.float()).abs()
        room = atol + rtol * w.float().abs()
        if slack and name in slack:
            room = room + slack[name]
        errs[name] = float(diff.max())
        share = max(share, float((diff / room).max()))
    return errs, share


def flash_errors(got, want, dtype, slack=None, grad_slack=None):
    """tol_share for o, lse, dq, dk, dv at the flash tolerance of dtype
    (dq and dk plus the elementwise ``grad_slack``, see delta_slack), and
    for dbias (when there is one) at DBIAS_TOL relative to its largest
    entry, plus the elementwise ``slack``."""
    errs, share = tol_share(got[:5], want[:5], FLASH_TOL[dtype],
                            ("o", "lse", "dq", "dk", "dv"), grad_slack)
    if len(got) > 5:
        a, rtol = DBIAS_TOL[dtype]
        ref = want[5].float().abs()
        diff = (got[5].float() - want[5].float()).abs()
        room = a * float(ref.max()) + rtol * ref
        if slack is not None:
            room = room + slack
        errs["dbias"] = float(diff.max())
        share = max(share, float((diff / room).max()))
    return errs, share


def dbias_slack(q, k, v, do, o, causal, bias, kv_mask, window=0,
                q_start=None):
    """bf16 room for K4 (see DBIAS_TOL): 2 * sum_b P_b * c_b per (h, q, k),
    with P the undropped softmax of the plain version (its causal band,
    window and document starts) and c_b the bound on a row's delta error
    from the kernels' bf16 o."""
    q, k, do = q.float(), k.float(), do.float()
    T, hd = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5 + bias
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], -1e30)
    if causal:
        seen = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        if window > 0:
            seen &= ~torch.ones_like(seen).tril(-window)
        s = s.masked_fill(~seen, float("-inf"))
    if q_start is not None:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(pos[None, None, None, :]
                          < q_start.long()[:, None, :, None], float("-inf"))
    c = 2 ** -9 * (do.abs() * o.float().abs()).sum(-1).transpose(1, 2)
    return 2 * torch.einsum("bhqk,bhq->hqk", torch.softmax(s, -1), c)


def delta_slack(q, k, v, do, o, bias, kv_mask, window, q_start):
    """bf16 room for dq and dk of packed rows: twice their error bound from
    delta taken from the kernels' bf16 o (as the JAX package takes it),
    c_i = 2**-9 * sum_d |dO||o| per row, which moves dS_ij by P_ij * c_i:
    dq_id by scale * c_i * sum_j P_ij |k_jd|, dk_jd by scale * sum_i P_ij
    c_i |q_id|, P the plain version's undropped softmax.  FLASH_TOL's atol
    was sized for rows over many keys, where |o| is small; a row of a
    short document sees few keys, so |o| nears |v| and c_i grows with hd
    (~0.16 at hd 128 for one-token documents)."""
    q, k, do = q.float(), k.float(), do.float()
    T, hd = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
    if bias is not None:
        s = s + bias
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], -1e30)
    pos = torch.arange(T, device=q.device)
    seen = pos[:, None] >= pos[None, :]
    if window > 0:
        seen &= pos[:, None] - pos[None, :] < window
    seen = seen & (pos[None, None, None, :]
                   >= q_start.long()[:, None, :, None])
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
    del s, seen
    c = 2 ** -9 * (do.abs() * o.float().abs()).sum(-1).transpose(1, 2)
    scale = 2.0 / hd ** 0.5
    return {"dq": scale * c.transpose(1, 2)[..., None]
            * torch.einsum("bhqk,bkhd->bqhd", p, k.abs()),
            "dk": scale * torch.einsum("bhqk,bhq,bqhd->bkhd", p, c,
                                       q.abs())}


def check_flash(case, window, dropout, seed, dtype, **kw):
    """Kernels against the plain version on one case: (errs, share)."""
    got = flash_kernels(*case, window, dropout, seed, **kw)
    want = flash_plain(*case, window, dropout, seed, **kw)
    slack = grad_slack = None
    if kw.get("bias") is not None and dtype == torch.bfloat16:
        slack = dbias_slack(*case, got[0], kw.get("causal", True),
                            kw["bias"], kw.get("kv_mask"), window,
                            kw.get("q_start"))
    if kw.get("q_start") is not None and dtype == torch.bfloat16:
        grad_slack = delta_slack(*case, got[0], kw.get("bias"),
                                 kw.get("kv_mask"), window, kw["q_start"])
    torch.cuda.synchronize()
    return flash_errors(got, want, dtype, slack, grad_slack)


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
                        errs, share = check_flash(case, window, dropout,
                                                  dseed, dtype)
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
    errs, share = check_flash(case, 0, 0.0, 0, torch.bfloat16)
    if not share <= 1.0:
        fail(f"flash kernels at the training shape: max|err| {errs}")
    # the ViT-B/16 path's shape: B 64, H 12, T 197 (no multiple of the
    # tiles), bidirectional, no bias, no key mask, no dropout
    v = VIT_SHAPE
    vit = {}
    for dtype in (torch.bfloat16, torch.float32):
        vcase = flash_case(rng, v["B"], v["T"], v["H"], v["hd"], dtype)
        verrs, vshare = check_flash(vcase, 0, 0.0, 0, dtype, causal=False)
        key = str(dtype).replace("torch.", "")
        vit[key] = {"max_abs_err": verrs, "share_of_tol": vshare}
        if not vshare <= 1.0:
            fail(f"flash kernels at the ViT shape, {key}: max|err| {verrs}")
    emit({"phase": "kernel", "kernel": "flash_attention (fwd, dq, dkv)",
          "cases": n_cases, "max_abs_err": worst,
          "tol_atol_rtol": {str(d).replace("torch.", ""): t
                            for d, t in FLASH_TOL.items()},
          "worst_share_of_tol": worst_share,
          "train_shape_share_of_tol": share,
          "hash_bits_checked": n_bits, "hash_bits_differing": 0,
          "train_shape_max_abs_err": errs,
          "vit_shape": dict(v, causal=False), "vit_shape_checks": vit})
    bf = vit["bfloat16"]["max_abs_err"]
    return {"flash_fwd": max(errs["o"], errs["lse"], bf["o"], bf["lse"]),
            "flash_bwd_dq": max(errs["dq"], bf["dq"]),
            "flash_bwd_dkv": max(errs["dk"], errs["dv"], bf["dk"], bf["dv"])}


def phase_flash_edges(seed):
    """The edges of the bf16 tensor-core K1, K2 and K3 and of the dbias
    folded into K3's pass: T no multiple of the 64-row tiles or the
    128-row blocks, windows that end inside a tile, fewer blocks than SMs
    (B*H 1 and 3), the T5 decoder's T 114 with a bias, and a batch row
    whose keys are all masked; at hd 64 and 128, under FLASH_TOL (dbias
    under DBIAS_TOL and its bf16 slack).  Then K3 with dbias twice at the
    T5 encoder's shape: dk, dv and dbias must be the same bits.  Then the
    packed rows' edges (q_start): document boundaries inside tiles the
    causal rule alone calls interior, one-token documents, a window, a
    bias (K4), a key mask over a document's every key; one document a row
    against no q_start, bit for bit; and the Qwen3 path's shape."""
    rng = np.random.default_rng(seed + 12)
    cases = []
    for T in (127, 129, 200, 1000):
        cases += [dict(B=1, H=1, T=T), dict(B=1, H=3, T=T, dropout=0.1),
                  dict(B=1, H=3, T=T, bias=True)]
    cases += [dict(B=1, H=3, T=1000, window=w) for w in (100, 129)]
    cases += [dict(B=1, H=3, T=1000, window=129, bias=True, dropout=0.1),
              dict(B=2, H=2, T=114, bias=True, dropout=0.1),
              dict(B=2, H=2, T=200, causal=False, mask="empty"),
              dict(B=2, H=2, T=200, causal=False, mask="empty", bias=True),
              dict(B=3, H=1, T=129, causal=False, mask="ragged", bias=True,
                   dropout=0.1),
              dict(B=3, H=1, T=127, causal=False, mask="empty", bias=True)]
    worst, worst_share, n_cases = {}, 0.0, 0
    for hd in (64, 128):
        for c in cases:
            case, b, m = flash_option_case(
                rng, c["B"], c["T"], c["H"], hd, torch.bfloat16,
                c.get("bias", False), c.get("mask"))
            dseed = int(rng.integers(-2 ** 31, 2 ** 31))
            errs, share = check_flash(case, c.get("window", 0),
                                      c.get("dropout", 0.0), dseed,
                                      torch.bfloat16,
                                      causal=c.get("causal", True), bias=b,
                                      kv_mask=m)
            worst_share = max(worst_share, share)
            for n, e in errs.items():
                worst[n] = max(worst.get(n, 0.0), e)
            if not share <= 1.0:
                fail(f"flash kernels bf16 hd={hd} {c}: max|err| {errs} past "
                     f"{FLASH_TOL[torch.bfloat16]}")
            n_cases += 1
    same = flash_determinism(rng)
    # packed rows on the tensor-core kernels: document boundaries inside
    # tiles the causal rule alone calls interior, one-token documents,
    # T no multiple of the tiles, a window, a bias (K4) and a key mask
    # over one document's keys; one document a row must give the same bits
    # as no q_start; and the Qwen3 path's own shape (B 4, T 4096, H 16,
    # hd 128, its packed documents)
    packed_cases = (
        [dict(B=1, H=3, T=T, kind=kind) for T in (200, 1000)
         for kind in ("interior", "ones")]
        + [dict(B=3, H=1, T=T, kind="docs") for T in (127, 129, 200, 1000)]
        + [dict(B=1, H=3, T=1000, kind="interior", window=129),
           dict(B=2, H=2, T=129, kind="interior", bias=True),
           dict(B=2, H=2, T=1000, kind="docs", bias=True, dropout=0.1),
           dict(B=2, H=2, T=1000, kind="interior", mask="doc")])
    packed, packed_share, cut, single = {}, 0.0, 0, {}
    for hd in (64, 128):
        errs, share, n = packed_flash_cases(rng, packed_cases,
                                            torch.bfloat16, hd)
        packed_share, cut = max(packed_share, share), cut + n
        for n_, e in errs.items():
            packed[n_] = max(packed.get(n_, 0.0), e)
        single[hd] = single_document_bits(rng, 2, 1000, 2, hd,
                                          torch.bfloat16)
    q = dict(QWEN3, **QWEN3_TRAFFIC)
    qcase = flash_case(rng, q["B"], q["T"], q["n_heads"], q["head_dim"],
                       torch.bfloat16)
    qs = torch.from_numpy(qwen3_starts(qwen3_rows(rng, q["B"])[0])).cuda()
    main_errs, main_share = check_flash(qcase, 0, 0.0, 0, torch.bfloat16,
                                        q_start=qs)
    del qcase
    if not main_share <= 1.0:
        fail(f"flash kernels at the Qwen3 packed shape: max|err| "
             f"{main_errs}")
    for n_, e in main_errs.items():
        packed[n_] = max(packed.get(n_, 0.0), e)
    emit({"phase": "kernel",
          "kernel": "flash_attention bf16 edges (K1, K2, K3 wgmma+TMA; "
                    "dbias folded into K3)",
          "cases": n_cases, "max_abs_err": worst,
          "tol_atol_rtol": FLASH_TOL[torch.bfloat16],
          "worst_share_of_tol": worst_share,
          "determinism": same,
          "q_start_cases": 2 * len(packed_cases) + 1,
          "q_start_max_abs_err": packed,
          "q_start_worst_share_of_tol": max(packed_share, main_share),
          "q_start_interior_tiles_cut": cut,
          "q_start_single_document_same_bits": single,
          "qwen3_packed_shape": {"B": q["B"], "T": q["T"],
                                 "H": q["n_heads"], "hd": q["head_dim"],
                                 "max_abs_err": main_errs,
                                 "share_of_tol": main_share}})
    for n_ in ("o", "lse", "dq", "dk", "dv", "dbias"):
        worst[n_] = max(worst[n_], packed.get(n_, 0.0))
    return {"flash_fwd": max(worst["o"], worst["lse"]),
            "flash_bwd_dq": worst["dq"],
            "flash_bwd_dkv": max(worst["dk"], worst["dv"]),
            "flash_bwd_dbias": worst["dbias"]}


def flash_determinism(rng):
    """K3 with dbias called twice on the same inputs at the T5 encoder's
    shape (bf16 B 16, H 12, T 512, bidirectional, ragged key mask, bias,
    dropout 0.1): dk, dv and dbias must be bit-identical (the batch sum
    has a fixed order and no atomics)."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_dbias,
        flash_fwd,
    )

    B, T, H, hd = 16, 512, 12, 64
    (q, k, v, do), bias, mask = flash_option_case(
        rng, B, T, H, hd, torch.bfloat16, True, "ragged")
    kw = dict(causal=False, bias=bias, kvm=additive_mask(mask))
    o, lse = flash_fwd(q, k, v, hd ** -0.5, 0, 0.1, 99, **kw)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    args = (q, k, v, do, lse, delta, hd ** -0.5, 0, 0.1, 99)
    first = flash_bwd_dkv_dbias(*args, **kw)
    second = flash_bwd_dkv_dbias(*args, **kw)
    torch.cuda.synchronize()
    same = {n: torch.equal(a, b)
            for n, a, b in zip(("dk", "dv", "dbias"), first, second)}
    if not all(same.values()):
        fail(f"K3 with dbias is not deterministic: bit-identical {same}")
    return same


def flash_option_case(rng, B, T, H, hd, dtype, bias, mask):
    """Random q, k, v, do and the options: a float32 (H, T, T) bias (or
    None) and a (B, T) key mask: None, "ragged" (row b keeps a random
    length >= T/2, row 0 all of T) or "empty" (the last row keeps no key)."""
    case = flash_case(rng, B, T, H, hd, dtype)
    b = (torch.from_numpy(rng.standard_normal((H, T, T), dtype=np.float32)
                          * 0.5).cuda() if bias else None)
    m = None
    if mask is not None:
        lengths = rng.integers(T // 2, T + 1, B)
        lengths[0] = T
        if mask == "empty":
            lengths[-1] = 0
        m = (torch.arange(T)[None, :] < torch.from_numpy(lengths)[:, None])
        m = m.cuda()
    return case, b, m


def doc_lengths(rng, T, kind):
    """Document lengths filling one packed row of T tokens: "docs" random
    (a quarter one-token documents, the rest 2-40 or up to T/3 tokens),
    "interior" boundaries at 70, 150, 151, 152, 153, 213 (inside key tiles
    the causal rule alone calls interior for the query tiles at 128 and
    192), then random; "ones" one-token documents over the first half;
    "single" one document."""
    if kind == "single":
        return [T]
    head = {"interior": [70, 80, 1, 1, 1, 60], "ones": [1] * (T // 2)}
    lengths, total = [], 0
    for n in head.get(kind, []):
        lengths.append(min(n, T - total))
        total += lengths[-1]
        if total == T:
            return lengths
    while total < T:
        n = int(rng.choice(
            [1, rng.integers(2, 41), rng.integers(2, max(3, T // 3))],
            p=[0.25, 0.5, 0.25]))
        lengths.append(min(n, T - total))
        total += lengths[-1]
    return lengths


def packed_starts(rng, B, T, kind):
    """(B, T) int32 document starts (q_start) on the card, each row packed
    by doc_lengths."""
    rows = []
    for _ in range(B):
        lengths = doc_lengths(rng, T, kind)
        rows.append(np.repeat(np.cumsum([0] + lengths[:-1]), lengths))
    return torch.from_numpy(np.stack(rows).astype(np.int32)).cuda()


def cut_interior_tiles(q_start, tile=64):
    """How many (64-row query tile, 64-key tile) pairs that causal position
    alone calls interior (every key at or before every query) hold a pair
    that q_start masks: the tiles an interior skip must not skip."""
    qs = q_start.cpu().numpy()
    B, T = qs.shape
    n = 0
    for i in range(T // tile):
        hi = qs[:, i * tile:(i + 1) * tile].max(1)        # per batch row
        for j in range(i):                               # k0 + 63 < q0
            n += int((hi > j * tile).sum())
    return n


def doc_kv_mask(q_start):
    """A (B, T) key mask that masks every key of one document per row (its
    rows attend uniformly over its keys) and one more key at random."""
    qs = q_start.cpu().numpy()
    m = np.ones(qs.shape, bool)
    for b in range(qs.shape[0]):
        starts = np.unique(qs[b])
        s = starts[len(starts) // 2]
        m[b, qs[b] == s] = False
        m[b, (s * 7 + 3) % qs.shape[1]] = False
    return torch.from_numpy(m).cuda()


def packed_flash_cases(rng, cases, dtype, hd):
    """Each case (a dict: B, T, H, kind, and bias, mask "doc" / "ragged",
    window, dropout) through check_flash with q_start: ({name: worst
    |err|}, worst share, interior tiles cut)."""
    worst, worst_share, cut = {}, 0.0, 0
    for c in cases:
        case, b, _ = flash_option_case(rng, c["B"], c["T"], c["H"], hd,
                                       dtype, c.get("bias", False), None)
        qs = packed_starts(rng, c["B"], c["T"], c["kind"])
        m = {None: None, "doc": doc_kv_mask(qs)}.get(c.get("mask"))
        cut += cut_interior_tiles(qs)
        errs, share = check_flash(case, c.get("window", 0),
                                  c.get("dropout", 0.0),
                                  int(rng.integers(-2 ** 31, 2 ** 31)),
                                  dtype, bias=b, kv_mask=m, q_start=qs)
        worst_share = max(worst_share, share)
        for n, e in errs.items():
            worst[n] = max(worst.get(n, 0.0), e)
        if not share <= 1.0:
            fail(f"flash kernels with q_start {dtype} hd={hd} {c}: "
                 f"max|err| {errs} past tolerance")
    return worst, worst_share, cut


def single_document_bits(rng, B, T, H, hd, dtype):
    """K1-K3 with q_start all 0 (one document a row) against no q_start on
    the same inputs: o, lse, dq, dk, dv must be the same bits."""
    case = flash_case(rng, B, T, H, hd, dtype)
    zeros = torch.zeros(B, T, dtype=torch.int32, device="cuda")
    one = flash_kernels(*case, 0, 0.0, 0, q_start=zeros)
    plain = flash_kernels(*case, 0, 0.0, 0)
    torch.cuda.synchronize()
    same = {n: torch.equal(a, b)
            for n, a, b in zip(("o", "lse", "dq", "dk", "dv"), one, plain)}
    if not all(same.values()):
        fail(f"q_start of one document changed the bits ({dtype} hd={hd} "
             f"T={T}): equal {same}")
    return same


def check_sink(rng, B, T, H, hd, dtype, causal=True, q_start=None):
    """The sink through flash_attention's autograd Function on the card (K1
    with the sink, K2, K3, dsink from the residuals) against autograd of
    the plain version in float32: o, dq, dk, dv under FLASH_TOL, and dsink
    within 1e-4 of the sum of its terms' sizes, sum |p_sink * delta|, plus
    for bf16 the delta slack of DBIAS_TOL, 2 * sum p_sink * c."""
    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_attention,
        reference_flash_attention,
    )

    q, k, v, do = flash_case(rng, B, T, H, hd, dtype)
    sink = torch.from_numpy(rng.standard_normal(H, dtype=np.float32)
                            * 2).cuda()
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    s = sink.clone().requires_grad_()
    o = flash_attention(*xs, causal=causal, sink=s, q_start=q_start)
    got = (o,) + torch.autograd.grad(o, xs + [s], do)
    xf = [t.float().requires_grad_() for t in (q, k, v)]
    sf = sink.clone().requires_grad_()
    o2, lse = reference_flash_attention(*xf, hd ** -0.5, causal=causal,
                                        sink=sf, q_start=q_start,
                                        return_lse=True)
    want = (o2,) + torch.autograd.grad(o2, xf + [sf], do.float())
    errs, share = tol_share(got[:4], want[:4], FLASH_TOL[dtype],
                            ("o", "dq", "dk", "dv"))
    p_sink = torch.exp(sink[None, :, None] - lse.detach())      # (B, H, T)
    delta = (do.float() * o2.detach()).sum(-1).transpose(1, 2)
    room = 1e-4 * float((p_sink * delta.abs()).sum((0, 2)).max())
    if dtype == torch.bfloat16:
        c = 2 ** -9 * (do.float().abs() * o.detach().float().abs()).sum(-1)
        room += 2 * float((p_sink * c.transpose(1, 2)).sum((0, 2)).max())
    errs["dsink"] = float((got[4] - want[4]).abs().max())
    share = max(share, errs["dsink"] / room)
    torch.cuda.synchronize()
    if not share <= 1.0:
        fail(f"flash kernels with a sink {dtype} hd={hd} T={T} "
             f"causal={causal}: max|err| {errs} (dsink room {room})")
    return errs, share

def phase_flash_options(seed):
    """K1-K4 with the options the T5 path takes, then packed rows (q_start
    with every option) and K1's sink, against the plain version; returns
    the worst errors at the T5 path's own two shapes and of the bf16
    packed and sink cases."""
    rng = np.random.default_rng(seed + 9)
    worst, worst_share, n_cases = {}, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for causal in (True, False):
                for T in ((512, 114) if causal else (512, 114, 200)):
                    for bias in (False, True):
                        masks = (None, "ragged") + (() if causal
                                                    else ("empty",))
                        for mask in masks:
                            for dropout in (0.0, 0.1):
                                case, b, m = flash_option_case(
                                    rng, 2, T, 2, hd, dtype, bias, mask)
                                dseed = int(rng.integers(-2 ** 31, 2 ** 31))
                                errs, share = check_flash(
                                    case, 0, dropout, dseed, dtype,
                                    causal=causal, bias=b, kv_mask=m)
                                worst_share = max(worst_share, share)
                                key = str(dtype).replace("torch.", "")
                                w = worst.setdefault(key, {})
                                for n, e in errs.items():
                                    w[n] = max(w.get(n, 0.0), e)
                                if not share <= 1.0:
                                    fail(f"flash kernels {key} hd={hd} T={T} "
                                         f"causal={causal} bias={bias} "
                                         f"mask={mask} dropout={dropout}: "
                                         f"max|err| {errs} past tolerance")
                                n_cases += 1
    # the T5 path's own shapes: bf16, B 16, H 12, hd 64, dropout 0.1; the
    # encoder (T 512, bidirectional, key mask of lengths 384-512, bias) and
    # the decoder's self-attention (T 114, causal, bias)
    main = {}
    for name, T, causal, mask in (("encoder", 512, False, "ragged"),
                                  ("decoder", 114, True, None)):
        case, b, m = flash_option_case(rng, 16, T, 12, 64, torch.bfloat16,
                                       True, mask)
        if m is not None:
            lengths = rng.integers(384, 513, 16)
            m = (torch.arange(T)[None, :]
                 < torch.from_numpy(lengths)[:, None]).cuda()
        dseed = int(rng.integers(-2 ** 31, 2 ** 31))
        errs, share = check_flash(case, 0, 0.1, dseed, torch.bfloat16,
                                  causal=causal, bias=b, kv_mask=m)
        if not share <= 1.0:
            fail(f"flash kernels at the T5 {name} shape: max|err| {errs}")
        main[name] = {"max_abs_err": errs, "share_of_tol": share}
    # packed rows: q_start with every option, float32 and bf16, hd 64 and
    # 128, random documents (a quarter one token long), a key mask that
    # masks one document's every key; and K1's sink, causal, bidirectional
    # and with q_start, its gradient against autograd of the plain version
    packed, sinks, n_packed, cut = {}, {}, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).replace("torch.", "")
        for hd in (64, 128):
            cases = [dict(B=2, T=T, H=2, kind="docs", bias=bias, mask=mask,
                          window=window, dropout=dropout)
                     for T in (512, 114) for bias in (False, True)
                     for mask in (None, "doc") for window in (0, 100)
                     for dropout in (0.0, 0.1)]
            errs, share, n = packed_flash_cases(rng, cases, dtype, hd)
            worst_share = max(worst_share, share)
            n_packed += len(cases)
            cut += n
            w = packed.setdefault(key, {})
            for n_, e in errs.items():
                w[n_] = max(w.get(n_, 0.0), e)
            for T, causal, docs in ((512, True, False), (200, False, False),
                                    (512, True, True)):
                qs = packed_starts(rng, 2, T, "docs") if docs else None
                errs, share = check_sink(rng, 2, T, 4, hd, dtype, causal,
                                         qs)
                worst_share = max(worst_share, share)
                w = sinks.setdefault(key, {})
                for n_, e in errs.items():
                    w[n_] = max(w.get(n_, 0.0), e)
    emit({"phase": "kernel",
          "kernel": "flash_attention options (fwd, dq, dkv, dbias)",
          "cases": n_cases, "max_abs_err": worst,
          "q_start_cases": n_packed, "q_start_max_abs_err": packed,
          "q_start_interior_tiles_cut": cut,
          "sink_cases": 12, "sink_max_abs_err": sinks,
          "dsink_tol": "1e-4 x sum |p_sink delta| (+ bf16 2 sum p_sink c)",
          "tol_atol_rtol": {str(d).replace("torch.", ""): t
                            for d, t in FLASH_TOL.items()},
          "dbias_tol_max_rel_rtol": {str(d).replace("torch.", ""): t
                                     for d, t in DBIAS_TOL.items()},
          "dbias_bf16_slack": "2 * sum_b P_b * 2**-9 * sum_d |dO||o|",
          "worst_share_of_tol": worst_share, "t5_shapes": main})
    errs = [main[n]["max_abs_err"] for n in main] + [packed["bfloat16"]]
    sk = sinks["bfloat16"]
    return {"flash_fwd": max(max(e["o"], e.get("lse", 0.0))
                             for e in errs + [sk]),
            "flash_bwd_dq": max(e["dq"] for e in errs + [sk]),
            "flash_bwd_dkv": max(max(e["dk"], e["dv"]) for e in errs + [sk]),
            "flash_bwd_dbias": max(e["dbias"] for e in errs)}


def adam_shapes(name):
    """The trained leaves of Qwen3-0.6B (tied head) and of the
    SDAR-30B-A3B cell's stage (4 layers of 128 stacked experts, a quarter
    of the vocabulary in and out), and which of them are norm leaves."""
    if name == "qwen3_0.6b":
        d, q, kv, hd, ff = 1024, 2048, 1024, 128, 3072
        layer = [(q, d), (kv, d), (kv, d), (d, q), (hd,), (hd,), (d,), (d,),
                 (ff, d), (ff, d), (d, ff)]
        shapes = [(151936, d)] + layer * 28 + [(d,)]
    else:
        d, q, kv, hd, e, ff, v = 2048, 4096, 512, 128, 128, 768, 37984
        layer = [(q, d), (kv, d), (kv, d), (d, q), (hd,), (hd,), (d,), (d,),
                 (e, d), (e, ff * 2, d), (e, d, ff)]
        shapes = [(v, d)] + layer * 4 + [(d,), (v, d)]
    return shapes, [len(s) == 1 for s in shapes]


def adam_draw(shape, seed):
    """p, g, m, v of one leaf on the card, from ``seed`` alone (so one
    leaf can be drawn again on its own)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p, g, m = (torch.randn(shape, device="cuda", generator=gen)
               for _ in "pgm")
    v = torch.rand(shape, device="cuda", generator=gen)
    return p, g, m.mul_(0.1), v.mul_(0.01)


def phase_adam(seed):
    """The fused Adam kernel against the foreach chain on the same card
    inputs, then timed (see the module's docstring)."""
    from neuralnetworklibrary_tpu_torch.core.optim import foreach_adam
    from neuralnetworklibrary_tpu_torch.ops import adam

    a = ADAM_STEP
    f32 = lambda x: float(np.float32(x))      # noqa: E731
    scalars = dict(lr=f32(a["lr"]), b1=f32(a["b1"]), omb1=f32(1 - a["b1"]),
                   b2=f32(a["b2"]), omb2=f32(1 - a["b2"]),
                   bc1=f32(1 - np.float32(a["b1"]) ** np.float32(a["t"])),
                   bc2=f32(1 - np.float32(a["b2"]) ** np.float32(a["t"])),
                   eps=a["eps"])
    decay = f32(np.float32(1) - np.float32(a["wd"]) * np.float32(a["lr"]))
    rtol, atol = ADAM_TOL
    timer = Timer()
    rows, worst = {}, 0.0
    for k, (name, clip_scale) in enumerate((("qwen3_0.6b", 0.37),
                                            ("sdar_30b_a3b", None))):
        shapes, is_norm = adam_shapes(name)
        seeds = [seed * 1000 + 100 * k + i for i in range(len(shapes))]
        # norm leaves take no weight decay (a bn_wd=False model) where the
        # clip is on; every leaf decays where it is off
        decays = [1.0 if norm and clip_scale else decay for norm in is_norm]
        scale = (None if clip_scale is None else
                 torch.tensor(clip_scale, device="cuda"))
        leaves = [adam_draw(sh, sd) for sh, sd in zip(shapes, seeds)]
        ps, gs, ms, vs = (list(x) for x in zip(*leaves))
        del leaves
        n = sum(p.numel() for p in ps)
        adam.adam.launches = adam.adam.elements = 0
        adam.adam(ps, gs, ms, vs, decays, scale=scale, **scalars)
        launches, elements = adam.adam.launches, adam.adam.elements
        torch.cuda.synchronize()
        if elements != n:
            fail(f"adam at {name}: the kernel updated {elements} of {n} "
                 f"elements")
        err = ratio = 0.0
        for i, (shape, sd) in enumerate(zip(shapes, seeds)):
            p, g, m, v = adam_draw(shape, sd)
            p.mul_(decays[i])
            if scale is not None:
                g.mul_(scale)
            foreach_adam([p], [g], [m], [v], **scalars)
            for got, want in ((ps[i], p), (ms[i], m), (vs[i], v)):
                diff = (got - want).abs_()
                err = max(err, float(diff.max()))
                ratio = max(ratio, float(
                    (diff / (atol + rtol * want.abs())).max()))
            del p, g, m, v, diff
        worst = max(worst, err)
        if not ratio <= 1.0:
            fail(f"adam at {name}: |kernel - foreach| over (atol {atol} + "
                 f"rtol {rtol} |foreach|) reaches {ratio}")

        def kernel():
            adam.adam(ps, gs, ms, vs, decays, scale=scale, **scalars)

        def chain():
            torch._foreach_mul_(ps, decay)
            if scale is not None:
                torch._foreach_mul_(gs, scale)
            foreach_adam(ps, gs, ms, vs, **scalars)

        steps = [torch.full((), float(a["t"]), device="cuda") for _ in ps]

        def library():
            torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=a["lr"],
                                beta1=a["b1"], beta2=a["b2"],
                                weight_decay=a["wd"], eps=a["eps"],
                                amsgrad=False, maximize=False)

        bound_ms = 28 * n / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "elements": n, "tensors": len(ps), "launches": launches,
            "max_abs_err": err, "err_over_tol": ratio,
            "clip_scale": clip_scale,
            **timed_row(timer.stats(kernel, reps=10, warmup=2),
                        timer.stats(chain, reps=10, warmup=2),
                        timer.stats(library, reps=10, warmup=2),
                        (bound_ms, "bytes"))}
        rows[name]["share_of_bound"] = bound_ms / rows[name]["ms"]
        del ps, gs, ms, vs, steps, scale
        torch.cuda.empty_cache()
    emit({"phase": "adam", "kernel": "adam", "tol": "atol %g + rtol %g"
          % (atol, rtol), "step": ADAM_STEP, **rows})
    return worst, rows


# fused Adam kernel counts of each training phase (adam_counted)
ADAM_PATHS = {}


def adam_counted(path, phase, *args):
    """``phase(*args)`` with the fused Adam kernel's counters from 0 and a
    tally of the elements ``Optimizer.apply`` trains on the card (the adam
    kind); fails unless each of those went through the kernel."""
    from neuralnetworklibrary_tpu_torch.core import optim
    from neuralnetworklibrary_tpu_torch.ops import adam

    trained = [0]
    apply = optim.Optimizer.apply

    def tally(self, params, grads, opt_state, partition, trainable, *a,
              **kw):
        if self.kind == "adam":
            trained[0] += sum(params[p].numel() for p, t in
                              zip(partition.paths, trainable)
                              if t and params[p].is_cuda)
        return apply(self, params, grads, opt_state, partition, trainable,
                     *a, **kw)

    adam.adam.launches = adam.adam.elements = 0
    optim.Optimizer.apply = tally
    try:
        out = phase(*args)
    finally:
        optim.Optimizer.apply = apply
    row = {"launches": adam.adam.launches, "elements": adam.adam.elements,
           "trained_elements": trained[0]}
    if row["elements"] != row["trained_elements"] or not row["launches"]:
        fail(f"{path}: the fused Adam kernel's launches and elements "
             f"{row}, not every trained element")
    ADAM_PATHS[path] = row
    return out


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
        dev_us = device_us(evt)
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
                          for us, k, n in rows[:12]],
          "paged_kernels": [{"name": k[:160], "ms": us / 1e3, "calls": n,
                             "share": us / 1e3 / total_ms}
                            for us, k, n in rows if "paged_" in k]})


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


def profile_step(step, phase="train_profile", focus=()):
    """Device time by kernel over one train step under torch.profiler, and
    the host ops that took the most host time of their own (the step is
    host-bound where the device is idle); with ``focus``, the time and
    share of the kernels whose names hold each of its strings."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append((evt.self_cpu_time_total, evt.key, evt.count))
            continue
        dev_us = device_us(evt)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    # copies and layout transposes (a conv net kept in channels_last shows
    # no NCHW <-> NHWC transpose per conv layer)
    copies = {k: (us / 1e3, n) for us, k, n in rows
              if "copy" in k or "nchwToNhwc" in k or "nhwcToNchw" in k}
    emit({"phase": phase, "wall_ms_profiled": wall * 1e3,
          "device_ms": total_ms,
          "device_busy_share": total_ms / (wall * 1e3),
          "copy_kernels": {"calls": sum(n for _, n in copies.values()),
                           "ms": sum(ms for ms, _ in copies.values()),
                           "layout_transposes": sum(
                               n for k, (_, n) in copies.items()
                               if "nchw" in k.lower() and "nhwc" in
                               k.lower())},
          "top_kernels": [{"name": k[:90], "ms": us / 1e3, "calls": n,
                           "share": us / 1e3 / total_ms}
                          for us, k, n in rows[:14]],
          **({"focus": {f: {"ms": ms, "share": ms / total_ms}
                        for f in focus for ms in [sum(
                            us for us, k, _ in rows if f in k) / 1e3]}}
             if focus else {}),
          "host_ms_own": sum(r[0] for r in host) / 1e3,
          "top_host_ops": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                           for us, k, n in host[:10]]})


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
    from neuralnetworklibrary_tpu_torch.ops.padded_head import padded_head
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
        counted = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, padded_head)
        for fn in counted:
            fn.launches = 0
        losses, step_s = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            losses.append(learner.train1minibatch(batch, 1e-4))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        val_loss = learner.evaluate("val")[0]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        peak = torch.cuda.max_memory_allocated()
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-4))
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 train losses not finite and falling: {losses}")
    if not np.isfinite(val_loss):
        fail(f"evaluate gave {val_loss}")
    n_eval = len(data.val_dl)
    # the 50,257-row head runs padded (ops/padded_head.py) in every
    # full-sequence forward: one product a step and one an eval batch
    want = {"flash_fwd": L * (10 + n_eval), "flash_bwd_dq": L * 10,
            "flash_bwd_dkv": L * 10, "padded_head": 10 + n_eval}
    if launches != want:
        fail(f"flash kernel and padded head launches {launches} != {want}")
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


def phase_auto_flash(seed):
    """The models' auto rule (``ops.flash_attention.use_flash``) on the
    card.  The default TransformerLM (d_model 256, 8 heads: hd 32, which
    the kernels do not take) trains one bf16 step through the Learner on
    its einsum path and launches no flash kernel; at 4 heads (hd 64) the
    same model takes the flash path (K1-K3 once per layer), and so do a
    sinks=True model (K1 with its sink) and a packed one (reset_at, K1-K3
    with q_start); flash_attention=True at hd 32 raises."""
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
    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa

    V, T, B = 512, 256, 8
    rng = np.random.default_rng(seed + 14)
    xs = rng.integers(0, V, (B, T + 1)).astype(np.int32)
    ds = ArrayDataset(xs[:, :-1], xs[:, 1:])
    data = types.SimpleNamespace(target_type="lang_model", bs=B,
                                 train_dl=DataLoader(ds, B, prefetch=0),
                                 val_dl=DataLoader(ds, B, prefetch=0))
    batch = data.train_dl.peek()
    counted = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out = {}
    for name, kw in (("default_hd32", {}), ("hd64", dict(n_heads=4)),
                     ("sinks_hd64", dict(n_heads=4, sinks=True)),
                     ("packed_hd64", dict(n_heads=4, reset_at=0))):
        torch.manual_seed(seed)
        model = TransformerLM(vocab_size=V, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            learner = Learner(tmp, data, model, "Adam2",
                              loss_func=SeqCrossEntropyLoss(), seed=seed,
                              compute_dtype="bfloat16")
            learner.init_optimizer(wd=1e-6)
            for fn in counted:
                fn.launches = 0
            loss = float(learner.train1minibatch(batch, 1e-3))
            torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        flash = model.uses_flash("cuda")
        want = {n: model.n_layers if flash else 0 for n in launches}
        if not np.isfinite(loss) or launches != want:
            fail(f"auto flash, {name} (head dim {model.head_dim}): loss "
                 f"{loss}, flash launches {launches} != {want}")
        out[name] = {"head_dim": model.head_dim, "flash": flash,
                     "loss": loss, "kernel_launches": launches}
    if out["default_hd32"]["flash"] or not all(
            out[n]["flash"] for n in ("hd64", "sinks_hd64", "packed_hd64")):
        fail(f"auto flash picked {out}")
    x = torch.from_numpy(xs[:2, :T]).long().cuda()
    forced = TransformerLM(vocab_size=V, flash_attention=True)
    try:
        with torch.no_grad():
            forced(x)
    except ValueError as e:
        out["forced_hd32_raises"] = str(e)
    else:
        fail("flash_attention=True at head dim 32 ran on the card")
    emit({"phase": "auto_flash", "model": "TransformerLM(vocab 512), "
          "default widths", "B": B, "T": T, "dtype": "bfloat16 (autocast)",
          **out})
    return out


def flash_bound(B, T, H, hd, kind, causal=True, bias=False, mask=False,
                pairs=None, extra=0):
    """Least time of one call at this shape: the bytes it must move (each
    input read once, each output written once) over HBM bandwidth, against
    its tensor-core flops at the bf16 peak.  Pairs are the causal (query,
    key) pairs, or all T*T when bidirectional, or ``pairs`` (the attended
    pairs of packed rows); a bias adds its (H, T, T) float32 read (and K4
    its dbias write), a key mask its (B, T) float32 read, and ``extra``
    bytes more (q_start's (B, T) int32).  Returns (ms, by)."""
    elem = B * T * H * hd * 2             # one bf16 (B, T, H, hd) tensor
    vec = B * H * T * 4                   # one float32 lse / delta row set
    if pairs is None:
        pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    extra += (H * T * T * 4 if bias else 0) + (B * T * 4 if mask else 0)
    nbytes, flops = {
        "flash_fwd": (4 * elem + vec, 4 * hd * pairs),
        "flash_bwd_dq": (5 * elem + 2 * vec, 6 * hd * pairs),
        "flash_bwd_dkv": (6 * elem + 2 * vec, 8 * hd * pairs),
        # q, k, v, dO, lse, delta in; dbias out: s and dP, 4*hd per pair
        "flash_bwd_dbias": (4 * elem + 2 * vec + H * T * T * 4,
                            4 * hd * pairs),
        # K3 with K4 folded in: K3's bytes and the dbias write (the bias
        # read is in ``extra``); the per-batch scratch is not counted, as
        # the least work the function needs does not move it
        "flash_bwd_dkv_dbias": (6 * elem + 2 * vec + H * T * T * 4,
                                8 * hd * pairs)}[kind]
    t_bytes = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_fwd_bwd(timer, fn, args, do, backend):
    """Stats of fn(*args) and of its backward alone (on a retained graph)
    with the SDPA backend pinned (for the plain version, backend None); for
    the backward also the CUDA-event stats without the spin and the
    profiler's mean, beside it."""
    import contextlib

    from torch.nn.attention import sdpa_kernel

    ctx = sdpa_kernel(backend) if backend is not None else (
        contextlib.nullcontext())
    with ctx:
        xs = [t.detach().requires_grad_() for t in args]
        fwd = timer.stats(lambda: fn(*xs), reps=10)
        out = fn(*xs)

        def bwd_fn():
            return torch.autograd.grad(out, xs, do, retain_graph=True)

        bwd = timer.stats(bwd_fn, reps=10)
        check = {"cuda_events_without_spin": timer.stats(bwd_fn, reps=10,
                                                         spin=False),
                 "profiler_mean_ms": timer.profiled_ms(bwd_fn)}
    return fwd, bwd, check


def flash_timing(seed, B, T, H, hd, causal, shape):
    """K1-K3 at one shape (bf16, no bias, no key mask, no dropout) by
    device time, beside the plain version and, as a yardstick the port
    never calls, SDPA with its cuDNN and its flash backend pinned in turn
    (the faster of the two; a backend that does not take the shape is
    listed with its error).  Returns {kernel: timed row}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
        reference_flash_attention,
    )

    rng = np.random.default_rng(seed)
    q, k, v, do = flash_case(rng, B, T, H, hd, torch.bfloat16)
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=causal)
    timer = Timer()
    o, lse = flash_fwd(q, k, v, scale, **kw)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    st = {"flash_fwd": timer.stats(lambda: flash_fwd(q, k, v, scale, **kw)),
          "flash_bwd_dq": timer.stats(lambda: flash_bwd_dq(
              q, k, v, do, lse, delta, scale, **kw)),
          "flash_bwd_dkv": timer.stats(lambda: flash_bwd_dkv(
              q, k, v, do, lse, delta, scale, **kw))}

    # the plain version (in bf16, as the port would run it) and the SDPA
    # yardstick: forward alone, and the backward alone (dq, dk, dv
    # together)
    plain_fwd, plain_bwd, _ = sdpa_fwd_bwd(
        timer, lambda a, b, c: reference_flash_attention(
            a, b, c, scale, causal=causal), (q, k, v), do, None)
    lib, lib_errors = {}, {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION):
        try:
            lib[backend.name] = sdpa_fwd_bwd(
                timer, lambda a, b, c: F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                    is_causal=causal).transpose(1, 2),
                (q, k, v), do, backend)
        except RuntimeError as e:   # the backend does not take this shape
            lib_errors[backend.name] = str(e)[:200]
    if not lib:
        fail(f"no SDPA backend takes the {shape} shape: {lib_errors}")
    yardstick = min(lib, key=lambda n: lib[n][0]["ms"] + lib[n][1]["ms"])
    lib_fwd, lib_bwd, lib_bwd_check = lib[yardstick]
    rows = {}
    for name in st:
        fwd = name == "flash_fwd"
        rows[name] = timed_row(st[name], plain_fwd if fwd else plain_bwd,
                               lib_fwd if fwd else lib_bwd,
                               flash_bound(B, T, H, hd, name, causal=causal))
        emit({"phase": "timing", "kernel": name, "shape": shape, "B": B,
              "T": T, "H": H, "hd": hd, "dtype": "bfloat16",
              "causal": causal, "design": FLASH_DESIGN[name], **rows[name],
              "plain": "reference_flash_attention in bf16"
                       + ("" if fwd else ": its backward, dq dk dv together"),
              "library": f"F.scaled_dot_product_attention(is_causal="
                         f"{causal}), backend {yardstick}, "
                         + ("forward" if fwd else
                            "backward, dq dk dv together")
                         + " (yardstick only)",
              "library_by_backend": {n: r[0 if fwd else 1]
                                     for n, r in lib.items()},
              **({"library_errors": lib_errors} if lib_errors else {}),
              **({} if fwd else {"library_bwd_check": lib_bwd_check}),
              "share_of_bound": rows[name]["bound_ms"] / rows[name]["ms"]})
    return rows


def phase_flash_timing(seed):
    """K1-K3 at the GPT-2 train shape (B 8, T 1024, causal)."""
    return flash_timing(seed + 5, 8, 1024, 12, 64, True, "gpt2_train")


def phase_vit_timing(seed):
    """K1-K3 at the ViT-B/16 shape (B 64, T 197, bidirectional)."""
    v = VIT_SHAPE
    return flash_timing(seed + 24, v["B"], v["T"], v["H"], v["hd"], False,
                        "vit")


def k5_timing_case(rng, label):
    """The inputs of K5's timing row ``label`` (K5_TIMING) and its
    description."""
    _, B, H, Hkv, hd, MB, pdt, off = next(r for r in K5_TIMING
                                          if r[0] == label)
    offs = ([off] * B if off is not None
            else [int(x) for x in rng.integers(32, 321, B)])
    case = paged_case(rng, B, H, Hkv, hd, 32, MB, pdt, torch.bfloat16, offs,
                      on_card=B * MB * Hkv * hd > 1 << 20)
    desc = {"shape": label, "B": B, "H": H, "Hkv": Hkv, "hd": hd, "bs": 32,
            "MB": MB, "offsets": off if off is not None else offs,
            "dtype": "bfloat16",
            "pool_dtype": str(pdt).replace("torch.", "")}
    return case, desc


def sdpa_yardsticks(timer, case):
    """K5's library yardsticks, SDPA on the strip gathered beforehand (not
    timed): (the strip cut to the longest live range, with a mask only
    where the offsets differ and the kv heads shared by enable_gqa, which
    reads what K5 reads; the whole strip of MB * bs positions with a mask
    and the kv heads repeated, PR 6's yardstick), each as Timer.stats."""
    import torch.nn.functional as F

    q, pk, pv = case["q"], case["pool_k"], case["pool_v"]
    B, H, hd = q.shape
    _, bs, Hkv, _ = pk.shape
    Mp = case["block_table"].shape[1] * bs
    tbl = case["block_table"].long()
    off = case["offsets"].long()
    qd = q[:, :, None, :]
    L = int(off.max()) + 1
    kd, vd = (pool[tbl].reshape(B, Mp, Hkv, hd)[:, :L].transpose(1, 2)
              .contiguous() for pool in (pk, pv))
    mask = (None if bool((off == off[0]).all()) else
            torch.arange(L, device="cuda")[None, None, None, :]
            <= off[:, None, None, None])
    cut = timer.stats(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=H != Hkv))
    kd, vd = (pool[tbl].reshape(B, Mp, Hkv, hd)
              .repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
              for pool in (pk, pv))
    mask = (torch.arange(Mp, device="cuda")[None, None, None, :]
            <= off[:, None, None, None])
    full = timer.stats(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    return cut, full


def phase_timing(seed):
    """K5 at each row of K5_TIMING: the kernel through the wrapper (its S
    as the wrapper chooses it), the plain version, and as the yardsticks
    the port never calls, SDPA on the strip gathered beforehand
    (sdpa_yardsticks: library_ms the one that reads what K5 reads,
    library_full_strip_ms PR 6's), except for int8 pools, where no one call
    computes the function."""
    from neuralnetworklibrary_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(seed + 1)
    timer = Timer()
    rows = {}
    for label, *_ in K5_TIMING:
        case, desc = k5_timing_case(rng, label)
        library = full = None
        if case["pool_k"].dtype != torch.int8:
            library, full = sdpa_yardsticks(timer, case)
        times = timed_row(
            timer.stats(lambda: pa.paged_attention(**case)),
            timer.stats(lambda: pa.reference_paged_attention(**case)),
            library, paged_bound(case))
        row = {**desc, "splits": pa.splits_for(case["q"], case["pool_k"],
                                               case["block_table"]),
               **times,
               "library": None if library is None else
               "F.scaled_dot_product_attention on the pre-gathered strip cut "
               "to the longest live range, kv heads by enable_gqa "
               "(yardstick only)",
               "library_full_strip_ms": None if full is None else full["ms"],
               "library_full_strip_ms_spread": None if full is None
               else [full["min"], full["max"]],
               "share_of_bound": times["bound_ms"] / times["ms"],
               "achieved_GBps": times["bound_ms"] / times["ms"]
               * HBM_BYTES_PER_S / 1e9
               if times["bound_by"] == "bytes" else None}
        emit({"phase": "timing", "kernel": "paged_attention", **row})
        rows[label] = row
        del case
    return rows


# K5 sweep variants: edited copies of csrc/paged_attention.cu, each a list
# of (text in the source, its replacement).  half_warps: 2 warps for blocks
# of 1-2 heads, 4 for 4-8; no_staging: nothing staged (the arithmetic runs
# on whatever shared memory holds); no_arithmetic: every chunk staged and
# waited for, no scores or PV.  The last two bound what each part costs.
K5_SWEEP_VARIANTS = {
    "half_warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
                   ("constexpr int kWarpsGqa = 8;",
                    "constexpr int kWarpsGqa = 4;")],
    "no_staging": [("    if (j < nch) stage_chunk(j);\n", ""),
                   ("    if (i + p.stages - 1 < nch) stage_chunk(i + p.stages"
                    " - 1);\n", "")],
    "no_arithmetic": [("    // scores of the warp's rows, and their max\n",
                       "    if (p.window == -12345) {  // never\n"),
                      ("    // the slot of chunk i + stages is chunk i's",
                       "    }\n    // the slot of chunk i + stages is chunk "
                       "i's")]}


def phase_paged_sweep(seed):
    """K5 at S in {1, chosen, 2 x chosen} as shipped and with half its
    warps, and the no_staging / no_arithmetic variants at the chosen S
    (K5_SWEEP_VARIANTS, each built into _build/), on the rows K5_SWEEP and
    long_context; then at long_context, K5 and SDPA without a mask on the
    gathered strip, under the Timer's write flush and a read flush."""
    import ctypes
    import subprocess as sp

    import torch.nn.functional as F

    from neuralnetworklibrary_tpu_torch.kernels import build
    from neuralnetworklibrary_tpu_torch.ops import paged_attention as pa

    src = (build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name, edits in K5_SWEEP_VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                fail(f"K5 sweep: {old!r} is not in the source once")
            text = text.replace(old, new)
        d = build.BUILD / f"sweep_k5_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "paged_attention.cu").write_text(text)
        procs[name] = sp.Popen([build.nvcc(), *build.FLAGS, "-o",
                                str(d / "lib.so"),
                                str(d / "paged_attention.cu")],
                               stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    libs = {"shipped": build.bind("paged_attention", pa.SIGNATURES)}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"K5 sweep variant {name} did not build:\n{log[-3000:]}")
        libs[name] = build.declare(ctypes.CDLL(str(
            build.BUILD / f"sweep_k5_{name}" / "lib.so")), pa.SIGNATURES)
        emit({"phase": "tile_sweep", "kernel": "paged_attention",
              "variant": name, "ptxas": ptxas_report(log)})
    rng = np.random.default_rng(seed + 1)
    timer = Timer()
    for label, *_ in K5_TIMING:
        case, desc = k5_timing_case(rng, label)
        if label not in K5_SWEEP + ("long_context",):
            continue
        chosen = pa.splits_for(case["q"], case["pool_k"],
                               case["block_table"])
        times = {}
        for name, lib in libs.items():
            sweep = name in ("shipped", "half_warps")
            with kernel_library("paged_attention", lib):
                for S in (sorted({1, chosen, 2 * chosen}) if sweep
                          else [chosen]):
                    st = timer.stats(lambda: pa._launch(**case, splits=S))
                    times[f"{name}_S{S}"] = [st["ms"], st["min"], st["max"]]
        emit({"phase": "tile_sweep", "kernel": "paged_attention", **desc,
              "chosen_splits": chosen,
              "times_ms_median_min_max": times,
              "bound_ms": paged_bound(case)[0]})
        if label == "long_context":
            B, H, hd = case["q"].shape
            Mp = case["block_table"].shape[1] * 32
            tbl = case["block_table"].long()
            kd, vd = (pool[tbl].reshape(B, Mp, H, hd).transpose(1, 2)
                      for pool in (case["pool_k"], case["pool_v"]))
            qd = case["q"][:, :, None, :]
            flush = {}
            for tname, t in (("write_flush", timer),
                             ("read_flush", Timer(flush="read"))):
                flush[tname] = {
                    "k5": t.stats(lambda: pa.paged_attention(**case))["ms"],
                    "sdpa_no_mask": t.stats(
                        lambda: F.scaled_dot_product_attention(
                            qd, kd, vd))["ms"]}
            emit({"phase": "tile_sweep", "kernel": "paged_attention",
                  "shape": label, "flush": flush,
                  "note": "every position is live at offset 1023, so SDPA "
                          "needs no mask here (yardstick only)"})


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


def lstm_pair(args, cluster=None, stages=None):
    """K6 on the inputs of lstm_case, then K7 on the plain version's
    residuals: ((got, want) forward, (got, want) backward, residuals)."""
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        STAGES,
        lstm_bwd,
        lstm_fwd,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    xp, w, h0, c0, dys, dhT, dcT = args
    kw = dict(cluster=cluster, stages=stages or STAGES)
    got = lstm_fwd(xp, w, h0, c0, **kw)
    want = reference_lstm_fwd(xp, w, h0, c0)
    wT, cprev = lstm_residuals(c0, want[1], w)
    res = (wT, want[2], want[1], cprev, dys, dhT, dcT)
    return (got, want), (lstm_bwd(*res, **kw), reference_lstm_bwd(*res)), res


LSTM_FWD_NAMES = ("ys", "cs", "gates", "hT", "cT")
LSTM_BWD_NAMES = ("dgates", "dh0", "dc0")


def lstm_edge_checks(rng):
    """K6/K7 where the plan matters, each against its plain version and
    against the split algorithm of its own plan (split_lstm_reference_*),
    under LSTM_TOL; then K6 and K7 twice on the same inputs, bit for bit.
    Returns the entries and the worst share of the tolerance."""
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        CLUSTERS,
        kernel_plan,
        lstm_bwd,
        lstm_fwd,
        split_lstm_reference_bwd,
        split_lstm_reference_fwd,
    )

    cases = [  # (label, B, T, H, cluster or None for the wrapper's)
        ("partial_last_cluster", 64, 7, 1030, 4),
        ("partial_last_cluster", 3, 7, 400, 8),
        ("partial_last_cluster", 65, 5, 130, 4),
        ("m_tiles", 65, 7, 1150, None), ("m_tiles", 127, 5, 1150, None),
        ("m_tiles", 127, 5, 400, None),
        ("b1_t1", 1, 1, 1150, None), ("b1_t1", 1, 1, 400, None),
        ("b1_t1", 1, 1, 25, None)]
    cases += [("cluster", 64, 7, H, C) for H in (1150, 400) for C in CLUSTERS]
    out, worst = [], 0.0
    for label, B, T, H, C in cases:
        try:
            plan = {k: kernel_plan(k, B, H, C) for k in ("fwd", "bwd")}
        except ValueError as e:   # a cluster size the card cannot hold
            if label != "cluster":
                raise
            out.append({"case": label, "B": B, "T": T, "H": H, "cluster": C,
                        "does_not_fit": str(e)})
            continue
        args = lstm_case(rng, B, T, H)
        (fg, fw), (bg, bw), res = lstm_pair(args, C)
        fs = split_lstm_reference_fwd(*args[:4], plan["fwd"])
        bs = split_lstm_reference_bwd(*res, plan["bwd"])
        torch.cuda.synchronize()
        entry = {"case": label, "B": B, "T": T, "H": H,
                 "cluster": {k: v["cluster"] for k, v in plan.items()},
                 "blocks": {k: v["blocks"] for k, v in plan.items()}}
        for kind, g, refs, names in (("fwd", fg, (fw, fs), LSTM_FWD_NAMES),
                                     ("bwd", bg, (bw, bs), LSTM_BWD_NAMES)):
            for ref_name, ref in zip(("plain", "split"), refs):
                errs, share = tol_share(g, ref, LSTM_TOL[kind], names)
                worst = max(worst, share)
                entry[f"{kind}_vs_{ref_name}_share_of_tol"] = share
                if not share <= 1.0:
                    fail(f"lstm edge {label} B={B} T={T} H={H} C={C} {kind} "
                         f"vs {ref_name}: max|err| {errs} past "
                         f"{LSTM_TOL[kind]}")
        out.append(entry)
    # two calls at the main shape and at a cluster-split one, bit for bit
    bits = {}
    for B, T, H in ((64, 75, 1150), (64, 75, 400)):
        args = lstm_case(rng, B, T, H)
        a = lstm_fwd(*args[:4])
        b = lstm_fwd(*args[:4])
        wT, cprev = lstm_residuals(args[3], a[1], args[1])
        res = (wT, a[2], a[1], cprev, *args[4:])
        c = lstm_bwd(*res)
        d = lstm_bwd(*res)
        torch.cuda.synchronize()
        bits[f"B{B}_T{T}_H{H}"] = {
            "fwd": all(torch.equal(x, y) for x, y in zip(a, b)),
            "bwd": all(torch.equal(x, y) for x, y in zip(c, d))}
        if not all(bits[f"B{B}_T{T}_H{H}"].values()):
            fail(f"lstm kernels not bit-identical over two calls: {bits}")
    return out, worst, bits


def phase_lstm_kernel(seed):
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        kernel_plan,
        lstm_scan,
    )

    rng = np.random.default_rng(seed + 6)
    worst, worst_share, n_cases = {}, {"fwd": 0.0, "bwd": 0.0}, 0
    main_err = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
    shapes = [(B, T, H) for B in (1, 3, 64) for T in (1, 7, 75)
              for H in (24, 400, 1150)]
    # odd H, and more batch rows than one chunk (K7 at B 128, K6 at B 1100)
    shapes += [(3, 7, 25), (128, 7, 1150), (1100, 3, 24)]
    # the classifier's long buckets (whole IMDB reviews from a zero state)
    long_shapes = [(64, T, H) for T in CLF_LONG_T for H in (1150, 400)]
    shapes += long_shapes
    long_share = {}
    for B, T, H in shapes:
        (got, want), (bgot, bwant), _ = lstm_pair(lstm_case(rng, B, T, H))
        torch.cuda.synchronize()
        for kind, g, wv, names in (("fwd", got, want, LSTM_FWD_NAMES),
                                   ("bwd", bgot, bwant, LSTM_BWD_NAMES)):
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
            if (B, T, H) in long_shapes:
                long_share[f"B{B}_T{T}_H{H}_{kind}"] = {
                    "max_abs_err": errs, "share_of_tol": share}
                key = "lstm_" + kind
                main_err[key] = max(main_err[key], max(errs.values()))
        n_cases += 1
    edges, edge_worst, bits = lstm_edge_checks(rng)

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
          "classifier_long_T": long_share,
          "edge_cases": edges, "edge_worst_share_of_tol": edge_worst,
          "bit_identical_calls": bits,
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


class kernel_library:
    """Within the block, the wrappers of ``csrc/<name>.cu`` launch the
    kernels of ``lib`` (an edited copy's library, its entry points
    declared) in place of the shipped library."""

    def __init__(self, name, lib):
        self.name, self.lib = name, lib

    def __enter__(self):
        from neuralnetworklibrary_tpu_torch.kernels import build

        self.saved = build.BOUND.get(self.name)
        build.BOUND[self.name] = self.lib

    def __exit__(self, *exc):
        from neuralnetworklibrary_tpu_torch.kernels import build

        if self.saved is None:
            del build.BOUND[self.name]
        else:
            build.BOUND[self.name] = self.saved


def lstm_timing_inputs(rng, B, T, H):
    """(K6 arguments, K7 arguments) at one shape, K7's residuals from K6."""
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import lstm_fwd

    xp, w, h0, c0, dys, dhT, dcT = lstm_case(rng, B, T, H)
    _, cs, gates, _, _ = lstm_fwd(xp, w, h0, c0)
    wT, cprev = lstm_residuals(c0, cs, w)
    return (xp, w, h0, c0), (wT, gates, cs, cprev, dys, dhT, dcT)


def phase_lstm_timing(seed):
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        kernel_plan,
        lstm_bwd,
        lstm_fwd,
        reference_lstm_bwd,
        reference_lstm_fwd,
    )

    rng = np.random.default_rng(seed + 8)
    timer = Timer()
    rows = {}
    B = AWD_LSTM["B"]
    # layers 1 and 2 of the LM at bptt 75, then of the classifier at
    # IMDB's common bucket
    for T, H, I in ((AWD_LSTM["bptt"], 1150, 1150),
                    (AWD_LSTM["bptt"], 400, 1150),
                    (CLF_TIMING_T, 1150, 1150), (CLF_TIMING_T, 400, 1150)):
        shape = "lm" if T == AWD_LSTM["bptt"] else "classifier"
        fargs, bargs = lstm_timing_inputs(rng, B, T, H)
        st = {"lstm_fwd": timer.stats(lambda: lstm_fwd(*fargs)),
              "lstm_bwd": timer.stats(lambda: lstm_bwd(*bargs))}
        # the per-step floor: the same launch with only the grid barriers
        with kernel_library("lstm_scan", LSTM_FLOOR["lib"]):
            floor = {"lstm_fwd": timer.stats(lambda: lstm_fwd(*fargs)),
                     "lstm_bwd": timer.stats(lambda: lstm_bwd(*bargs))}
        plain = {"lstm_fwd": timer.stats(lambda: reference_lstm_fwd(*fargs),
                                         reps=5),
                 "lstm_bwd": timer.stats(lambda: reference_lstm_bwd(*bargs),
                                         reps=5)}
        # layer-level yardstick the port never calls: cuDNN's LSTM in bf16
        # on the same layer, which also does the input projection
        lstm = torch.nn.LSTM(I, H, batch_first=True).cuda().to(
            torch.bfloat16)
        x = torch.from_numpy(rng.normal(0, 1, (B, T, I)).astype(
            np.float32)).cuda().to(torch.bfloat16).requires_grad_()
        h0, c0 = fargs[2], fargs[3]
        hc = (h0[None].to(torch.bfloat16), c0[None].to(torch.bfloat16))
        wrt = [x] + list(lstm.parameters())
        with torch.no_grad():
            lib_fwd = timer.stats(lambda: lstm(x, hc))
        out = lstm(x, hc)[0]
        gy = torch.randn_like(out)
        lib_bwd = timer.stats(lambda: torch.autograd.grad(
            out, wrt, gy, retain_graph=True))
        lib_fwd_bwd = timer.stats(lambda: torch.autograd.grad(
            lstm(x, hc)[0], wrt, gy))
        library = {"lstm_fwd": lib_fwd, "lstm_bwd": lib_bwd}
        for name in st:
            kind = name.split("_")[1]
            row = timed_row(st[name], plain[name], library[name],
                            lstm_bound(B, T, H, name))
            emit({"phase": "timing", "kernel": name, "shape": shape,
                  "B": B, "T": T, "H": H, **row,
                  "ms_per_step": row["ms"] / T,
                  "plan": kernel_plan(kind, B, H),
                  "barriers_only_ms": floor[name]["ms"],
                  "barriers_only_ms_spread": [floor[name]["min"],
                                              floor[name]["max"]],
                  "floor_ms_per_step": floor[name]["ms"] / T,
                  "plain": ("reference_lstm_fwd" if name == "lstm_fwd"
                            else "reference_lstm_bwd") + " on the card",
                  "library": f"torch.nn.LSTM({I}, {H}) bf16 (cuDNN), "
                             + ("forward" if name == "lstm_fwd" else
                                "backward alone")
                             + "; layer-level yardstick: it also does the "
                               "input projection",
                  "library_fwd_bwd_ms": lib_fwd_bwd["ms"],
                  "share_of_bound": row["bound_ms"] / row["ms"]})
            full = {**row, "barriers_only_ms": floor[name]["ms"],
                    "library_fwd_bwd_ms": lib_fwd_bwd["ms"]}
            if shape == "lm" and H == 1150:   # the LM's widest layers
                rows[name] = {**full, "plan": kernel_plan(kind, B, H)}
            elif shape == "classifier":
                rows[name].setdefault("classifier", {})[f"T{T}_H{H}"] = full
    return rows


LSTM_ABLATIONS = {"no_multiply": 1, "no_staging": 2, "barriers_only": 3}
# enum TraceEdge of csrc/lstm_scan.cu, in order
LSTM_TRACE_EDGES = ("step", "tile", "multiplied", "partials", "exchanged",
                    "reduced", "cell", "arrived", "stored")


def lstm_trace_phases(stamps):
    """Median SM cycles of each phase of a step, from the trace build's
    stamps of one call: a step runs from one "step" edge to the next; each
    phase ends at the first stamp of its edge (the first tile apart from
    the rest of the ring), and "barrier" is the stores' end to the next
    step.  Steps 2 to T - 2 only."""
    steps, cur = [], None
    for v in stamps:
        edge, t = LSTM_TRACE_EDGES[v & 15], v >> 4
        if edge == "step":
            if cur is not None:
                cur["next"] = t
            cur = {"step": t}
            steps.append(cur)
        elif cur is not None:
            key = "first_tile" if edge == "tile" else edge
            cur.setdefault(key, t)
    order = ("step", "first_tile", "multiplied", "partials", "exchanged",
             "reduced", "cell", "arrived", "stored", "next")
    phases = {}
    for st in steps[1:-1]:
        seen = [k for k in order if k in st]
        for a, b in zip(seen, seen[1:]):
            name = "barrier" if b == "next" else b
            phases.setdefault(name, []).append(st[b] - st[a])
        phases.setdefault("step_total", []).append(st["next"] - st["step"])
    return {k: statistics.median(v) for k, v in phases.items()}


def phase_lstm_sweep(seed):
    """K6 and K7 at B 64, T 75, H 1150 and 400 (the LM's layers) with
    every cluster size and two ring depths, then the shipped plan built
    without the multiply, without the staging and with only the grid
    barriers: the measurement behind default_cluster and STAGES of
    ops/lstm_scan.py.  A plan that does not fit is listed, not timed.  Then
    the trace build at T 10: the median SM cycles of each phase of a step
    (lstm_trace_phases) on block 0."""
    import ctypes

    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        CLUSTERS,
        STAGES,
        _run,
        kernel_plan,
        lstm_bwd,
        lstm_fwd,
    )

    started = [lstm_variant_start(label, kAblate=a)
               for label, a in LSTM_ABLATIONS.items()]
    started.append(lstm_variant_start("trace", kTrace=1))
    libs = {s[0]: lstm_variant_load(s)[0] for s in started}
    trace_lib = libs.pop("trace")
    rng = np.random.default_rng(seed + 14)
    timer = Timer()
    B, T = AWD_LSTM["B"], AWD_LSTM["bptt"]
    fns = {"lstm_fwd": lstm_fwd, "lstm_bwd": lstm_bwd}
    for H in (1150, 400):
        fargs, bargs = lstm_timing_inputs(rng, B, T, H)
        args = {"lstm_fwd": fargs, "lstm_bwd": bargs}
        times = {}
        for name, fn in fns.items():
            kind = name.split("_")[1]
            for C in CLUSTERS:
                for stages in (2, STAGES):
                    key = f"C{C}_stages{stages}"
                    try:
                        plan = kernel_plan(kind, B, H, C, stages)
                    except ValueError as e:
                        times.setdefault(name, {})[key] = str(e)
                        continue
                    st = timer.stats(lambda: fn(*args[name], cluster=C,
                                                stages=stages), reps=10)
                    times.setdefault(name, {})[key] = {
                        "ms": st["ms"], "spread": [st["min"], st["max"]],
                        "blocks": plan["blocks"],
                        "units_per_block": plan["units_per_block"],
                        "smem_bytes": plan["smem_bytes"]}
            for label, lib in libs.items():
                with kernel_library("lstm_scan", lib):
                    st = timer.stats(lambda: fn(*args[name]), reps=10)
                times[name][label] = {"ms": st["ms"],
                                      "spread": [st["min"], st["max"]]}
        # where a step's time goes: the trace build, T 10, SM cycles
        trace = {}
        targs = {"lstm_fwd": [a[:10] if i == 0 else a
                              for i, a in enumerate(fargs)],
                 "lstm_bwd": [a[:10] if i in (1, 2, 3, 4) else a
                              for i, a in enumerate(bargs)]}
        stamps = (ctypes.c_longlong * 4096)()
        count = ctypes.c_int()
        with kernel_library("lstm_scan", trace_lib):
            for name, fn in fns.items():
                _run("nnl_lstm_trace", stamps, ctypes.byref(count))
                fn(*targs[name])
                torch.cuda.synchronize()
                _run("nnl_lstm_trace", stamps, ctypes.byref(count))
                trace[name] = lstm_trace_phases(stamps[:count.value])
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        emit({"phase": "lstm_sweep", "B": B, "T": T, "H": H,
              "shipped": {k: kernel_plan(k, B, H) for k in ("fwd", "bwd")},
              "times_ms": times, "trace_cycles_T10": trace,
              "sm_clock_now_max": clocks})


def t5_params(seed, cfg):
    """A flax-shaped params tree for TransformerSeq2Seq(**cfg) (T5 layout:
    relative-bias tables, RMSNorm scales, relu MLP, tied head): dense
    kernels, embeddings and bias tables normal(0, 0.02) from numpy, biases
    0, norm scales 1."""
    rng = np.random.default_rng(seed)
    D, V, F, H = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"], cfg["n_heads"]

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": np.zeros(o, np.float32)}

    def norm():
        return {"scale": np.ones(D, np.float32)}

    def mlp():
        return {"fc_in": dense(D, F), "fc_out": dense(F, D)}

    tree = {"word_embed": normal(V, D), "enc_ln": norm(), "dec_ln": norm(),
            "enc_rel_bias": normal(cfg["rel_buckets"], H),
            "dec_rel_bias": normal(cfg["rel_buckets"], H)}
    for i in range(cfg["enc_layers"]):
        tree[f"enc_block_{i}"] = {
            "ln1": norm(), "ln2": norm(), "mlp": mlp(),
            "attn": {"qkv": dense(D, 3 * D), "out": dense(D, D)}}
    for i in range(cfg["dec_layers"]):
        tree[f"dec_block_{i}"] = {
            "ln1": norm(), "ln2": norm(), "ln3": norm(), "mlp": mlp(),
            "self_attn": {"qkv": dense(D, 3 * D), "out": dense(D, D)},
            "cross": {"q": dense(D, D), "kv": dense(D, 2 * D),
                      "out": dense(D, D)}}
    return tree


def t5_batches(rng, n_rows, tr):
    """(src, tgt_in, tgt_out) for n_rows random pairs, collated as T5 is:
    pad 0, eos 1, the decoder starting from pad; source lengths drawn from
    [src_min, src], targets of tgt tokens + eos."""
    from neuralnetworklibrary_tpu_torch.nn.seq2seq import seq2seq_collate

    V = T5["vocab_size"]
    pairs = [(rng.integers(2, V, int(rng.integers(tr["src_min"],
                                                  tr["src"] + 1))),
              rng.integers(2, V, tr["tgt"])) for _ in range(n_rows)]
    return seq2seq_collate(pairs, pad=0, bos=0, eos=1, max_src=tr["src"],
                           max_tgt=tr["tgt"])


def phase_t5(seed, profile=False):
    import tempfile
    import types

    from neuralnetworklibrary_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.nn.seq2seq import (
        Seq2SeqCrossEntropyLoss,
        TransformerSeq2Seq,
        seq2seq_generate,
    )
    from neuralnetworklibrary_tpu_torch.nn.transformer import MLP
    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
    from neuralnetworklibrary_tpu_torch.utils.jax_params import (
        load_jax_params,
    )

    tr = T5_TRAFFIC
    t0 = time.perf_counter()
    model = TransformerSeq2Seq(**T5, flash_attention=True)
    load_jax_params(model, t5_params(seed, T5))
    setup_s = time.perf_counter() - t0
    L = T5["enc_layers"] + T5["dec_layers"]
    rng = np.random.default_rng(seed + 10)
    loss_fn = Seq2SeqCrossEntropyLoss(0)

    # (a) f32, B 2: loss and every gradient, flash path against einsum path.
    # The MLPs run gelu for this check: at relu's kink the two paths'
    # float32 round-off sends a pre-activation within ~1e-7 of 0 to the
    # other branch now and then, which moves that unit's whole gradient term
    # (3% of its weight's largest entry in a first run); gelu is smooth
    # there, and every attention shape stays T5-base's.
    mlps = [m for m in model.modules() if isinstance(m, MLP)]
    src, tin, tout = (torch.from_numpy(a).long().cuda()
                      for a in t5_batches(rng, 2, tr))
    res = []
    for flash in (True, False):
        model.flash_attention = flash
        model.zero_grad(set_to_none=True)
        for m in mlps:
            m.act = "gelu"
        loss = loss_fn(model(src, tin), tout)
        loss.backward()
        res.append((float(loss.detach()), {n: p.grad.clone()
                                           for n, p in model.named_parameters()}))
    for m in mlps:
        m.act = T5["mlp_act"]
    model.flash_attention = True
    model.zero_grad(set_to_none=True)
    loss_err = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    g_err = {n: float((res[0][1][n] - g).abs().max()
                      / g.abs().max().clamp(min=1e-30))
             for n, g in res[1][1].items()}
    del res
    worst_g = max(g_err, key=g_err.get)
    if not loss_err <= T5_LOSS_RTOL:
        fail(f"T5 f32 flash vs einsum loss: relative err {loss_err}")
    if not g_err[worst_g] <= T5_GRAD_TOL:
        fail(f"T5 f32 flash vs einsum gradient {worst_g}: err / max "
             f"{g_err[worst_g]}")

    # (b) the configuration through the Learner; (c) generation
    B = tr["B"]
    train = ArrayDataset(*t5_batches(rng, B, tr))
    val = ArrayDataset(*t5_batches(rng, B * tr["eval_batches"], tr))
    data = types.SimpleNamespace(
        target_type="seq2seq", bs=B, train_dl=DataLoader(train, B, prefetch=0),
        val_dl=DataLoader(val, B, prefetch=0))
    batch = data.train_dl.peek()
    kernels = [getattr(fa, n) for n in FLASH_KERNELS]
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", loss_func=loss_fn,
                          seed=seed, compute_dtype="bfloat16")
        learner.init_optimizer(wd=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        losses, step_s = [], []
        for _ in range(tr["steps"]):
            t0 = time.perf_counter()
            losses.append(learner.train1minibatch(batch, 1e-4))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        val_loss = learner.evaluate("val")[0]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        peak = torch.cuda.max_memory_allocated()
        for fn in kernels:
            fn.launches = 0
        gen_src = torch.from_numpy(batch.xs[0][:2]).cuda()
        toks = seq2seq_generate(model, gen_src, tr["gen_tokens"], bos=0)
        torch.cuda.synchronize()
        gen_launches = {fn.__name__: fn.launches for fn in kernels}
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-4),
                         "t5_profile")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"T5 train losses not finite and falling: {losses}")
    if not np.isfinite(val_loss):
        fail(f"T5 evaluate gave {val_loss}")
    n_eval = len(data.val_dl)
    steps = tr["steps"]
    want = {"flash_fwd": L * (steps + n_eval), "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps, "flash_bwd_dbias": L * steps}
    if launches != want:
        fail(f"T5 flash kernel launches {launches} != {want}")
    want_gen = {n: 0 for n in FLASH_KERNELS}
    want_gen["flash_fwd"] = T5["enc_layers"]
    if gen_launches != want_gen:
        fail(f"seq2seq_generate launched {gen_launches}, not {want_gen}")
    if (tuple(toks.shape) != (2, tr["gen_tokens"])
            or not bool(((toks >= 0) & (toks < T5["vocab_size"])).all())):
        fail(f"seq2seq_generate gave {toks}")
    steady = statistics.median(step_s[1:])
    tokens = int(batch.xs[0].size + batch.xs[1].size)
    emit({"phase": "t5", "model": "t5-base v1.0 (random weights)",
          "setup_s": setup_s,
          "params": sum(p.numel() for p in model.parameters()),
          "f32_flash_vs_einsum_loss_rel_err": loss_err,
          "f32_flash_vs_einsum_grad_err_over_max": g_err[worst_g],
          "f32_worst_grad": worst_g,
          "f32_rel_bias_grad_err_over_max": {
              n: g_err[n] for n in ("enc_rel_bias", "dec_rel_bias")},
          "f32_tol": f"loss {T5_LOSS_RTOL} relative, grads {T5_GRAD_TOL} x "
                     f"max|grad| per tensor",
          "f32_check_mlp_act": "gelu (relu's kink flips on round-off)",
          "dtype": "bfloat16 (autocast)", "B": B, "src_len": tr["src"],
          "src_real_len": [tr["src_min"], tr["src"]],
          "tgt_len": tr["tgt"] + 1, "optimizer": "Adam2", "lr": 1e-4,
          "wd": 0.0, "drop": T5["drop"], "steps": steps, "losses": losses,
          "val_loss": val_loss, "eval_batches": n_eval, "eval_s": eval_s,
          "first_step_ms": step_s[0] * 1e3,
          "ms_per_step_median_2_to_10": steady * 1e3,
          "src_plus_tgt_tokens_per_s": tokens / steady,
          "peak_memory_GB": peak / 1e9, "kernel_launches": launches,
          "generated": toks.tolist(), "generate_kernel_launches":
          gen_launches})
    return {n: launches[n] + gen_launches[n] for n in FLASH_KERNELS}


def phase_t5_timing(seed):
    """K1-K4 at the T5 encoder's shape (bf16 B 16, H 12, T 512, hd 64,
    bidirectional, key mask of lengths 384-512, bias, dropout 0.1)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_dbias,
        flash_bwd_dq,
        flash_fwd,
        reference_flash_attention,
    )

    B, T, H, hd, rate = 16, 512, 12, 64, 0.1
    rng = np.random.default_rng(seed + 11)
    q, k, v, do = flash_case(rng, B, T, H, hd, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal((H, T, T), dtype=np.float32)
                            * 0.5).cuda()
    lengths = torch.from_numpy(rng.integers(384, 513, B))
    mask = (torch.arange(T)[None, :] < lengths[:, None]).cuda()
    kvm = additive_mask(mask)
    dseed = int(rng.integers(-2 ** 31, 2 ** 31))
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=False, bias=bias, kvm=kvm)
    timer = Timer()
    o, lse = flash_fwd(q, k, v, scale, 0, rate, dseed, **kw)
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, T).contiguous())
    args = (q, k, v, do, lse, delta, scale, 0, rate, dseed)
    st = {"flash_fwd": timer.stats(lambda: flash_fwd(
              q, k, v, scale, 0, rate, dseed, **kw)),
          "flash_bwd_dq": timer.stats(lambda: flash_bwd_dq(*args, **kw)),
          "flash_bwd_dkv": timer.stats(lambda: flash_bwd_dkv(*args, **kw)),
          # K4 runs inside K3's pass (plus the batch sum): its row is the
          # fused call's, dk, dv and dbias together
          "flash_bwd_dbias": timer.stats(lambda: flash_bwd_dkv_dbias(
              *args, **kw))}
    # K3 at the same shape with none of the options (bidirectional only):
    # what the bias, key mask and dropout cost it
    o0, lse0 = flash_fwd(q, k, v, scale, causal=False)
    delta0 = ((do.float() * o0.float()).sum(-1).transpose(1, 2)
              .reshape(B * H, T).contiguous())
    no_options = timer.stats(lambda: flash_bwd_dkv(
        q, k, v, do, lse0, delta0, scale, causal=False))

    # the plain version, and as a yardstick only, never called by the
    # port: SDPA's memory-efficient backend with the bias and the key mask
    # as one float attn_mask that requires grad (its own dropout); forward
    # alone and backward alone (dq dk dv dbias together), by device time
    plain_fwd, plain_bwd, _ = sdpa_fwd_bwd(
        timer, lambda a, b, c, bb: reference_flash_attention(
            a, b, c, scale, causal=False, dropout=rate, dropout_seed=dseed,
            bias=bb, kv_mask=mask), (q, k, v, bias), do, None)
    lib_fwd, lib_bwd, lib_bwd_check = sdpa_fwd_bwd(
        timer, lambda a, b, c, bb: F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=(bb[None] + kvm[:, None, None, :]).to(a.dtype),
            dropout_p=rate).transpose(1, 2),
        (q, k, v, bias), do, SDPBackend.EFFICIENT_ATTENTION)
    rows = {}
    for name in st:
        fwd = name == "flash_fwd"
        fused = name == "flash_bwd_dbias"
        rows[name] = timed_row(st[name], plain_fwd if fwd else plain_bwd,
                               lib_fwd if fwd else lib_bwd,
                               flash_bound(B, T, H, hd,
                                           "flash_bwd_dkv_dbias" if fused
                                           else name, causal=False,
                                           bias=True, mask=True))
        if name == "flash_bwd_dkv":
            rows[name]["no_options_ms"] = no_options["ms"]
            rows[name]["no_options_ms_spread"] = [no_options["min"],
                                                  no_options["max"]]
        if fused:
            rows[name]["call"] = ("flash_bwd_dkv_dbias: K3 with dS per batch "
                                  "row, then the batch sum (dk, dv, dbias)")
            rows[name]["over_dkv_alone_ms"] = (rows[name]["ms"]
                                               - rows["flash_bwd_dkv"]["ms"])
        emit({"phase": "timing", "kernel": name, "shape": "t5_encoder",
              "B": B, "T": T, "H": H, "hd": hd, "dtype": "bfloat16",
              "causal": False, "bias": True, "kv_mask": "lengths 384-512",
              "dropout": rate, "design": FLASH_DESIGN[name], **rows[name],
              "plain": "reference_flash_attention in bf16"
                       + ("" if fwd else
                          ": its backward, dq dk dv dbias together"),
              "library": "F.scaled_dot_product_attention with the bias + "
                         "key mask as a float attn_mask requiring grad, "
                         "backend EFFICIENT_ATTENTION, "
                         + ("forward" if fwd else
                            "backward, dq dk dv dbias together")
                         + " (yardstick only)",
              **({} if fwd else {"library_bwd_check": lib_bwd_check}),
              "share_of_bound": rows[name]["bound_ms"] / rows[name]["ms"]})
    return rows


# --------------------------------------------------------------- vision


def image_data(xs, ys, B, classes, transforms=None):
    """A data object over uint8 NHWC images: the first B rows are the
    train batch, the rest the val batches."""
    import types

    from neuralnetworklibrary_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )

    return types.SimpleNamespace(
        target_type="single_label", bs=B, sz=xs.shape[1],
        categories={i: str(i) for i in range(classes)},
        transforms=transforms,
        train_dl=DataLoader(ArrayDataset(xs[:B], ys[:B]), B, prefetch=0),
        val_dl=DataLoader(ArrayDataset(xs[B:], ys[B:]), B, prefetch=0))


def synthetic_images(rng, n, classes, px):
    """uint8 (n, px, px, 3) noise images and int32 labels from the seed's
    rng, as __graft_entry__.py's _SyntheticImageData makes them, with the
    label made recoverable from the image as it does there: the top eighth
    of each image in its class's colour, which flips and lighting keep.
    (From random weights a frozen senet154 on pure noise gives features
    the labels cannot be fitted to: its loss stays flat.)"""
    xs = rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
    ys = rng.integers(0, classes, n).astype(np.int32)
    xs[:, :px // 8] = np.stack([ys * 2 % 256, ys * 37 % 256,
                                ys * 101 % 256], -1)[:, None, None]
    return xs, ys


def normalize_pipeline(generator, xs, train):
    from neuralnetworklibrary_tpu_torch.ops.augment import (
        imagenet_stats,
        normalize_batch,
    )

    return (normalize_batch(xs[0], imagenet_stats),) + tuple(xs[1:])


def graft_pipeline(generator, xs, train):
    """__graft_entry__.py's pipeline: the device augmentation with the warp
    (SideOn, max_deg 10, max_zoom 1.05) in training, else normalize."""
    from neuralnetworklibrary_tpu_torch.ops.augment import (
        augment_batch,
        imagenet_stats,
    )

    if not train:
        return normalize_pipeline(generator, xs, train)
    return (augment_batch(generator, xs[0], tfm_type="SideOn", max_deg=10,
                          max_zoom=1.05, stats=imagenet_stats),) + tuple(
        xs[1:])


def card_and_cpu_grads(models, xs, y, loss_fn):
    """One train-mode forward and backward of the same model on each device
    (xs, y on the CPU): [(output, {name: grad}), ...] on the CPU."""
    out = []
    for m in models:
        dev = next(m.parameters()).device
        m.zero_grad(set_to_none=True)
        pred = m(*[x.to(dev) for x in xs], train=True)
        loss_fn(pred, y.to(dev)).backward()
        out.append((pred.detach().cpu(),
                    {n: p.grad.cpu() for n, p in m.named_parameters()}))
    return out


def grads_err(models, x, y):
    """One train-mode forward and backward of the same model on each
    device (x, y on the CPU): max |logits diff|, max |logits|, max |grad
    diff| and max |grad| over every parameter."""
    import torch.nn.functional as F

    (lc, gc), (lg, gg) = card_and_cpu_grads(models, [x], y, F.cross_entropy)
    return (float((lg - lc).abs().max()), float(lc.abs().max()),
            max(float((gg[n] - g).abs().max()) for n, g in gc.items()),
            max(float(g.abs().max()) for g in gc.values()))


def vision_card_vs_cpu(seed):
    """(a) resnet50 and senet154 with their own classifiers (mean pool
    and a linear layer: at B 2 the concat-pool head's BatchNorms would
    normalize over two samples), 120 classes, B 2, 224 px, train mode, on
    the card against the same model on the CPU, in float32 and in float64
    (VISION_CPU_TOL); the device augmentation's
    stages, given one draw, on the card against the CPU."""
    import copy

    from neuralnetworklibrary_tpu_torch.nn.resnet import resnet50
    from neuralnetworklibrary_tpu_torch.nn.senet import SENet
    from neuralnetworklibrary_tpu_torch.ops.augment import (
        apply_augment,
        draw_augment_params,
        imagenet_stats,
        normalize_batch,
    )

    V = VISION
    rng = np.random.default_rng(seed + 20)
    xs, ys = synthetic_images(rng, 8, V["classes"], V["px"])
    x = normalize_batch(torch.from_numpy(xs[:2]), imagenet_stats).permute(
        0, 3, 1, 2)
    y = torch.from_numpy(ys[:2]).long()
    nets = {"resnet50": lambda: resnet50(V["classes"], device="cpu"),
            # senet154's body and classifier, without its dropout
            "senet154": lambda: SENet("senet", (3, 8, 36, 3), 64, 16,
                                      dropout_p=None,
                                      num_classes=V["classes"],
                                      device="cpu")}
    res = {}
    keys = ("logits_max_abs_err", "logits_max_abs", "grad_max_abs_err",
            "grad_max_abs")
    for arch, make in nets.items():
        torch.manual_seed(seed)
        cpu = make()
        card = copy.deepcopy(cpu).cuda()
        t0 = time.perf_counter()
        f32 = dict(zip(keys, grads_err((cpu, card), x, y)))
        f64 = dict(zip(keys, grads_err((cpu.double(), card.double()),
                                       x.double(), y)))
        res[arch] = {"float32": f32, "float64": f64,
                     "seconds": time.perf_counter() - t0}
        if not (f32["logits_max_abs_err"]
                <= VISION_CPU_TOL * f32["logits_max_abs"]
                and f64["logits_max_abs_err"]
                <= VISION_CPU_TOL * f64["logits_max_abs"]
                and f64["grad_max_abs_err"]
                <= VISION_CPU_TOL * f64["grad_max_abs"]):
            fail(f"{arch} card vs CPU: {res[arch]}")
        del cpu, card
    imgs = torch.from_numpy(xs).cuda()
    g = torch.Generator("cuda").manual_seed(seed)
    aug = {}
    for tfm in ("SideOn", "TopDown"):
        p = draw_augment_params(g, imgs, tfm_type=tfm, max_deg=10,
                                max_zoom=1.05, max_noise=0.1)
        got = apply_augment(imgs, p, imagenet_stats).cpu()
        want = apply_augment(imgs.cpu(), {k: v.cpu() for k, v in p.items()},
                             imagenet_stats)
        aug[tfm] = float((got - want).abs().max())
        if not aug[tfm] <= AUG_TOL:
            fail(f"augmentation {tfm} card vs CPU: max|err| {aug[tfm]}")
    emit({"phase": "vision", "part": "card vs CPU", "B": 2,
          "px": V["px"], "head": "mean pool + linear, 120 classes",
          "models": res,
          "tol": f"float32 logits, float64 logits and grads: "
                 f"{VISION_CPU_TOL} x max (TF32 off); float32 grads "
                 f"reported, not held (see VISION_CPU_TOL)",
          "augment_stages": "warp (max_deg 10, zoom 1.05) + flip / "
                            "dihedral + lighting + noise 0.1 + normalize, "
                            "B 8, one draw",
          "augment_max_abs_err": aug, "augment_tol": AUG_TOL})


def timed_steps(learner, batch, lr, steps):
    """``steps`` train1minibatch calls, each synchronised: (losses, the
    seconds of each)."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(learner.train1minibatch(batch, lr))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return [float(v) for v in losses], secs


def step_report(losses, secs, B, peak):
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    steady = statistics.median(secs[1:])
    return {"losses": losses, "first_step_ms": secs[0] * 1e3,
            "ms_per_step_median_2_to_10": steady * 1e3,
            "img_per_s": B / steady, "peak_memory_GB": peak / 1e9}


def vision_senet154(seed, profile=False):
    """(b) bench.py's build_learner("senet154", frozen=True), on synthetic
    images: ImageLearner, get_transforms("SideOn", 224), bf16, Adam2,
    freeze(), wd 1e-4, lr 1e-3; 10 steps on one batch, evaluate('val')."""
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.vision import (
        ImageClassificationNet,
        ImageLearner,
        get_transforms,
    )

    V = VISION
    B = V["B"]
    rng = np.random.default_rng(seed + 21)
    xs, ys = synthetic_images(rng, B * (1 + V["eval_batches"]),
                              V["classes"], V["px"])
    data = image_data(xs, ys, B, V["classes"],
                      get_transforms("SideOn", V["px"]))
    torch.manual_seed(seed)
    model = ImageClassificationNet.create(data, "senet154")
    batch = data.train_dl.peek()
    with tempfile.TemporaryDirectory() as tmp:
        learner = ImageLearner(tmp, data, model, "Adam2", seed=seed)
        learner.freeze()
        learner.init_optimizer(wd=1e-4)
        bn = model.body.layer4_2.b3.bn
        stats0 = (bn.running_mean.clone(), bn.running_var.clone())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(learner, batch, 1e-3, V["steps"])
        peak = torch.cuda.max_memory_allocated()
        moved = not (torch.equal(bn.running_mean, stats0[0])
                     or torch.equal(bn.running_var, stats0[1]))
        t0 = time.perf_counter()
        val_loss, val_acc = learner.evaluate("val")
        eval_s = time.perf_counter() - t0
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-3),
                         "senet154_profile")
    if not moved:
        fail("senet154 freeze(): the body's BatchNorm statistics did not "
             "move in training")
    if not (np.isfinite(val_loss) and 0.0 <= val_acc <= 1.0):
        fail(f"senet154 evaluate gave {val_loss}, {val_acc}")
    n_eval = V["eval_batches"] * B
    emit({"phase": "vision", "part": "senet154 frozen fine-tune",
          "config": "bench.py build_learner('senet154', frozen=True): "
                    "ImageLearner, get_transforms('SideOn', 224), Adam2, "
                    "freeze(), wd 1e-4", "dtype": "bfloat16 (autocast)",
          "B": B, "px": V["px"], "classes": V["classes"], "lr": 1e-3,
          "steps": V["steps"], **step_report(losses, secs, B, peak),
          "body_bn_stats_moved": moved, "val_loss": val_loss,
          "val_accuracy": val_acc, "eval_images": n_eval,
          "eval_s": eval_s, "eval_img_per_s": n_eval / eval_s})


def vision_resnet50(seed):
    """(c) bench_resnet50_mfu's learner (resnet50 unfrozen, B 64, bf16,
    Adam2) through Learner(input_pipeline=) with the graft entry's device
    augmentation; (d) bn_freeze('non_head') for one step at B 8."""
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.vision import (
        ImageClassificationNet,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner

    V = VISION
    B = V["B"]
    rng = np.random.default_rng(seed + 22)
    xs, ys = synthetic_images(rng, B * (1 + V["eval_batches"]),
                              V["classes"], V["px"])
    data = image_data(xs, ys, B, V["classes"])
    torch.manual_seed(seed)
    model = ImageClassificationNet.create(data, "resnet50")
    batch = data.train_dl.peek()
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", seed=seed,
                          compute_dtype="bfloat16",
                          input_pipeline=graft_pipeline)
        learner.init_optimizer(wd=1e-4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(learner, batch, 1e-3, V["steps"])
        peak = torch.cuda.max_memory_allocated()
        val_loss, val_acc = learner.evaluate("val")
        # the augmentation alone on the device batch, by CUDA events
        xs_dev = learner._to_device(batch)[0]
        aug = Timer().stats(lambda: graft_pipeline(
            learner.pipeline_generator, xs_dev, True), reps=10)
    if not np.isfinite(val_loss):
        fail(f"resnet50 evaluate gave {val_loss}")
    emit({"phase": "vision", "part": "resnet50 unfrozen",
          "config": "bench.py bench_resnet50_mfu's learner through "
                    "Learner(input_pipeline=) with __graft_entry__.py's "
                    "augment_batch(SideOn, max_deg 10, max_zoom 1.05)",
          "dtype": "bfloat16 (autocast)", "B": B, "px": V["px"],
          "classes": V["classes"], "lr": 1e-3, "wd": 1e-4,
          "steps": V["steps"], **step_report(losses, secs, B, peak),
          "val_loss": val_loss, "val_accuracy": val_acc,
          "augment_ms_per_batch": aug["ms"],
          "augment_ms_spread": [aug["min"], aug["max"]]})

    # (d) bn_freeze('non_head'): the body's BatchNorm parameters and
    # buffers stay bit for bit, the head moves
    b8 = image_data(xs[:16], ys[:16], 8, V["classes"])
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, b8, model, "Adam2", seed=seed,
                          compute_dtype="bfloat16",
                          input_pipeline=graft_pipeline)
        learner.bn_freeze("non_head")
        bn_state = {n: t.clone() for n, t in
                    list(model.body.named_parameters())
                    + list(model.body.named_buffers())
                    if ".bn." in f".{n}"}
        head = {n: t.clone() for n, t in model.head.named_parameters()}
        loss = float(learner.train1minibatch(b8.train_dl.peek(), 1e-3))
        torch.cuda.synchronize()
    body = dict(list(model.body.named_parameters())
                + list(model.body.named_buffers()))
    changed = [n for n, t in bn_state.items() if not torch.equal(body[n], t)]
    head_moved = sum(not torch.equal(p, head[n])
                     for n, p in model.head.named_parameters())
    if changed or head_moved != len(head) or not np.isfinite(loss):
        fail(f"bn_freeze('non_head'): body bn tensors changed {changed[:5]}, "
             f"head tensors moved {head_moved} of {len(head)}, loss {loss}")
    emit({"phase": "vision", "part": "bn_freeze('non_head'), resnet50",
          "B": 8, "loss": loss, "body_bn_tensors_unchanged": len(bn_state),
          "head_tensors_moved": head_moved})


def phase_vision(seed, profile=False):
    vision_card_vs_cpu(seed)
    vision_senet154(seed, profile)
    vision_resnet50(seed)


def phase_vit(seed, profile=False):
    """ViT-B/16 (google/vit-base-patch16-224's widths, random weights):
    (a) f32 B 2, flash path against the einsum path; (b) bf16 B 64
    through the Learner with a normalize_batch pipeline, 10 steps, then
    evaluate over 2 batches.  K1-K3 launches are counted over (b)."""
    import tempfile

    import torch.nn.functional as F

    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.nn.vit import ViT
    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
    from neuralnetworklibrary_tpu_torch.ops.augment import (
        imagenet_stats,
        normalize_batch,
    )

    V = VISION
    B, L = V["B"], VIT_B16["n_layers"]
    rng = np.random.default_rng(seed + 23)
    xs, ys = synthetic_images(rng, B * (1 + V["eval_batches"]),
                              V["classes"], V["px"])
    torch.manual_seed(seed)
    model = ViT(num_classes=V["classes"], **VIT_B16, flash_attention=True)

    # (a) f32, B 2: loss and every gradient, flash path against einsum path
    x = normalize_batch(torch.from_numpy(xs[:2]).cuda(), imagenet_stats)
    y = torch.from_numpy(ys[:2]).long().cuda()
    res = []
    for flash in (True, False):
        model.flash_attention = flash
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x, train=True), y)
        loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    model.flash_attention = True
    model.zero_grad(set_to_none=True)
    loss_err = abs(res[0][0] - res[1][0])
    g_max = max(float(g.abs().max()) for g in res[1][1].values())
    g_err = max(float((res[0][1][n] - g).abs().max())
                for n, g in res[1][1].items())
    del res
    if not (np.isfinite(loss_err) and loss_err <= 1e-4):
        fail(f"ViT f32 flash vs einsum loss: |err| {loss_err} > 1e-4")
    if not g_err <= 1e-3 * g_max:
        fail(f"ViT f32 flash vs einsum grads: max|err| {g_err} > 1e-3 x "
             f"max|grad| {g_max}")

    # (b) bf16, B 64, through the Learner
    data = image_data(xs, ys, B, V["classes"])
    batch = data.train_dl.peek()
    counted = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", seed=seed,
                          compute_dtype="bfloat16",
                          input_pipeline=normalize_pipeline)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        losses, secs = timed_steps(learner, batch, 1e-4, V["steps"])
        peak = torch.cuda.max_memory_allocated()
        val_loss, val_acc = learner.evaluate("val")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, 1e-4),
                         "vit_profile")
    want = {"flash_fwd": L * (V["steps"] + V["eval_batches"]),
            "flash_bwd_dq": L * V["steps"], "flash_bwd_dkv": L * V["steps"]}
    if launches != want:
        fail(f"ViT flash kernel launches {launches} != {want}")
    if not np.isfinite(val_loss):
        fail(f"ViT evaluate gave {val_loss}")
    emit({"phase": "vit", "model": "ViT-B/16 (google/vit-base-patch16-224 "
          "widths), random weights", **VIT_B16,
          "f32_flash_vs_einsum_loss_abs_err": loss_err,
          "f32_flash_vs_einsum_grad_max_abs_err": g_err,
          "f32_grad_max_abs": g_max,
          "f32_tol": "loss 1e-4, grads 1e-3 x max|grad|",
          "dtype": "bfloat16 (autocast)", "B": B, "T": VIT_SHAPE["T"],
          "classes": V["classes"], "optimizer": "Adam2", "lr": 1e-4,
          "steps": V["steps"], **step_report(losses, secs, B, peak),
          "val_loss": val_loss, "val_accuracy": val_acc,
          "eval_batches": V["eval_batches"], "kernel_launches": launches})
    return launches


# ----------------------------------------------------- the other workloads


def review_corpus(rng, n, cfg):
    """n synthetic IMDB-like reviews as a numericalized TextDataset:
    lengths log-normal (median CLF median, sigma), clipped; token ids
    uniform over the vocabulary past the four specials, with 5% of each
    review drawn from 50 words of its label's own (so the label can be
    learned); labels balanced at random."""
    from neuralnetworklibrary_tpu_torch.applications.text import TextDataset

    V = cfg["vocab"]
    lens = np.clip(np.round(np.exp(rng.normal(np.log(cfg["median"]),
                                              cfg["sigma"], n))),
                   cfg["min_len"], cfg["max_len"]).astype(int)
    labels = rng.integers(0, cfg["classes"], n)
    texts = []
    for L, lab in zip(lens, labels):
        t = rng.integers(4, V, L)
        planted = rng.random(L) < 0.05
        t[planted] = 4 + 50 * lab + rng.integers(0, 50, planted.sum())
        texts.append(t.tolist())
    ds = object.__new__(TextDataset)
    ds.stoi = {"_unk_": 0, "_pad_": 1, "_bos_": 2, "_eos_": 3,
               **{f"w{i}": i for i in range(4, V)}}
    ds.texts, ds.labels = texts, labels.tolist()
    ds.num_tokens = int(lens.sum())
    ds.label_dict = {i: i for i in range(cfg["classes"])}
    return ds


def clf_kernel_vs_loop(model, batches, seed):
    """The classifier in float32, eval mode, on each batch, the kernels'
    path (lstm_kernel None) against the float32 step loop (False): the CE
    loss, the logits and the encoder's output; and the gradient of every
    encoder parameter for sum(enc_out * R), R a fixed normal draw of
    enc_out's shape.  Returns one entry per batch.

    The kernels sit in the encoder, so its parameters' gradients are the
    ones gated.  The decoder's are not: from random weights the reviews'
    pooled features differ by a few percent across the batch, so a ReLU
    or attention unit near its kink flips for every review at once when
    the features move by the bf16 rounding of the kernels' path, and a
    whole row of its gradient changes; the CE gradients (decoder
    included) are reported beside, ungated."""
    import torch.nn.functional as F

    out = []
    gen = torch.Generator().manual_seed(seed)
    for b in batches:
        x = torch.from_numpy(b.xs[0]).long().cuda()
        y = torch.from_numpy(b.y).long().cuda()
        res = []
        for kernel in (None, False):
            model.lstm_kernel = kernel
            model.zero_grad(set_to_none=True)
            logits, enc_out = model(x)
            loss = F.cross_entropy(logits, y)
            loss.backward(retain_graph=True)
            ce_grads = {n: p.grad.clone()
                        for n, p in model.named_parameters()}
            if kernel is None:
                R = torch.randn(enc_out.shape, generator=gen).to(
                    enc_out.device)
            model.zero_grad(set_to_none=True)
            (enc_out * R).sum().backward()
            res.append((logits.detach(), enc_out.detach(),
                        float(loss.detach()), ce_grads,
                        {n: p.grad.clone()
                         for n, p in model.enc.named_parameters()}))
        model.lstm_kernel = None
        model.zero_grad(set_to_none=True)
        (lk, ek, lossk, cek, gk), (ll, el, lossl, cel, gl) = res
        g_err = {n: rel_err(gk[n], g) for n, g in gl.items()}
        # (the attention scores' biases have gradient 0, a softmax over
        # time not seeing a shift common to every step: left out)
        ce_err = {n: rel_err(cek[n], g) for n, g in cel.items()
                  if n not in ("dec.attn1.bias", "dec.attn2.bias")}
        entry = {"T": x.shape[1], "loss_kernel": lossk, "loss_loop": lossl,
                 "loss_rel_err": abs(lossk - lossl) / abs(lossl),
                 "logit_err_over_max": rel_err(lk, ll),
                 "enc_out_err_over_max": rel_err(ek, el),
                 "enc_grad_err_over_max": max(g_err.values()),
                 "worst_enc_grad": max(g_err, key=g_err.get),
                 "ce_grad_err_over_max_ungated": max(ce_err.values()),
                 "worst_ce_grad": max(ce_err, key=ce_err.get)}
        if not (entry["loss_rel_err"] <= LM_LOSS_RTOL
                and max(entry["logit_err_over_max"],
                        entry["enc_out_err_over_max"],
                        entry["enc_grad_err_over_max"]) <= LM_GRAD_TOL):
            fail(f"classifier f32 kernel vs loop at T {x.shape[1]}: {entry}")
        out.append(entry)
    return out


def phase_classifier(seed, profile=False):
    """The IMDB classifier, ULMFiT stage 2 (examples/imdb.py:78-96), on the
    card: K6 at every forward, K7 at the unfrozen steps' backward."""
    import tempfile
    import types

    import torch.nn.functional as F

    from neuralnetworklibrary_tpu_torch.applications.text import (
        LanguageModelNet,
        RegSeqCrossEntropyLoss,
        TextClassificationAccuracy,
        TextClassificationDataObj,
        TextClassificationNet,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
        lstm_bwd,
        lstm_fwd,
    )

    cfg = IMDB_CLF
    B = cfg["B"]
    rng = np.random.default_rng(seed + 31)
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    data = TextClassificationDataObj(review_corpus(rng, cfg["n_train"], cfg),
                                     review_corpus(rng, cfg["n_val"], cfg),
                                     None, B, bpg=cfg["bpg"], seed=seed)
    setup_s = time.perf_counter() - t0
    pad = data.stoi["_pad_"]
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the LM Learner at the same vocabulary, and the transfer
        lm = LanguageModelNet(vocab_size=len(data.stoi), pad_token=pad)
        lm_learner = Learner(tmp, types.SimpleNamespace(
            target_type="lang_model", bs=B), lm, "Adam2",
            loss_func=RegSeqCrossEntropyLoss(2.0, 1.0), seed=seed)
        model, transfer = TextClassificationNet.from_language_model(
            lm_learner, cfg["classes"], attn_size=cfg["attn"],
            fc_layer_sizes=cfg["fc"])
        transfer(model)
        lm_enc = dict(lm.enc.named_parameters())
        same = all(torch.equal(p, lm_enc[n])
                   for n, p in model.enc.named_parameters())
        del lm, lm_learner, lm_enc, transfer
        if not same:
            fail("from_language_model: the encoder differs from the LM's")
        L = model.num_layers

        # (2) f32: kernels against the float32 step loop at two buckets:
        # the loader's batch of the 64 shortest reviews (shuffled groups
        # never make one that short) and the first train batch at 512
        epoch0 = list(data.train_dl)
        by_T = {b.xs[0].shape[1]: b for b in reversed(epoch0)}
        by_T[CLF_CHECK_T[0]] = data.train_dl._make_batch(
            data.train_dl.order[-B:])
        if not all(by_T.get(T) is not None and by_T[T].xs[0].shape[1] == T
                   for T in CLF_CHECK_T):
            fail(f"no train batch at buckets {CLF_CHECK_T}: {sorted(by_T)}")
        f32 = clf_kernel_vs_loop(model, [by_T[T] for T in CLF_CHECK_T],
                                 seed)

        learner = Learner(tmp, data, model, "Adam2", seed=seed,
                          compute_dtype="bfloat16")
        learner.init_optimizer(wd=cfg["wd"], clip=cfg["clip"])

        def run(batches, lr):
            rows = []
            for b in batches:
                t0 = time.perf_counter()
                loss = learner.train1minibatch(b, lr)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                tokens = int((b.xs[0][:b.n_valid] != pad).sum())
                rows.append({"T": b.xs[0].shape[1], "loss": float(loss),
                             "ms": secs * 1e3, "docs": b.n_valid,
                             "tokens": tokens})
            return rows

        # (3) frozen: the head alone trains, the encoder runs forward only
        learner.freeze()
        enc0 = {n: p.detach().clone()
                for n, p in model.enc.named_parameters()}
        lstm_fwd.launches = lstm_bwd.launches = 0
        frozen = run(epoch0[:cfg["frozen_steps"]], cfg["frozen_lr"])
        launches = {"frozen": {"lstm_fwd": lstm_fwd.launches,
                               "lstm_bwd": lstm_bwd.launches}}
        enc_kept = all(torch.equal(p, enc0[n])
                       for n, p in model.enc.named_parameters())
        del enc0
        # (4) unfrozen, a new epoch: the group of the longest reviews
        # comes first, its 10 batches shuffled
        learner.unfreeze()
        learner.init_optimizer(wd=cfg["wd"], clip=cfg["clip"])
        epoch1 = list(data.train_dl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lstm_fwd.launches = lstm_bwd.launches = 0
        steps = run(epoch1[:cfg["unfrozen_steps"]], cfg["lrs"])
        peak = torch.cuda.max_memory_allocated()
        launches["unfrozen"] = {"lstm_fwd": lstm_fwd.launches,
                                "lstm_bwd": lstm_bwd.launches}
        # (5) evaluate, (6) predict
        lstm_fwd.launches = lstm_bwd.launches = 0
        t0 = time.perf_counter()
        val = learner.evaluate("val", [TextClassificationAccuracy(), "auc"])
        eval_s = time.perf_counter() - t0
        launches["evaluate"] = {"lstm_fwd": lstm_fwd.launches,
                                "lstm_bwd": lstm_bwd.launches}
        lstm_fwd.launches = lstm_bwd.launches = 0
        probs, labels = learner.predict("val")
        launches["predict"] = {"lstm_fwd": lstm_fwd.launches,
                               "lstm_bwd": lstm_bwd.launches}
        if profile:
            b512 = by_T[CLF_TIMING_T]
            profile_step(lambda: learner.train1minibatch(b512, cfg["lrs"]),
                         "classifier_profile",
                         focus=("lstm_fwd_tc_kernel", "lstm_bwd_tc_kernel"))
    n_eval = len(data.val_dl)
    want = {"frozen": {"lstm_fwd": L * cfg["frozen_steps"], "lstm_bwd": 0},
            "unfrozen": {"lstm_fwd": L * cfg["unfrozen_steps"],
                         "lstm_bwd": L * cfg["unfrozen_steps"]},
            "evaluate": {"lstm_fwd": L * n_eval, "lstm_bwd": 0},
            "predict": {"lstm_fwd": L * n_eval, "lstm_bwd": 0}}
    if launches != want:
        fail(f"classifier K6/K7 launches {launches} != {want}")
    if not enc_kept:
        fail("freeze(): the classifier's encoder moved")
    losses = [r["loss"] for r in frozen + steps]
    if not all(np.isfinite(losses)):
        fail(f"classifier train losses not finite: {losses}")
    longest = max(b.xs[0].shape[1] for b in epoch1)
    if max(r["T"] for r in steps) != longest:
        fail(f"the unfrozen steps ran buckets {[r['T'] for r in steps]}, "
             f"not the loader's longest, {longest}")
    y_val = np.concatenate([b.y[:b.n_valid] for b in data.val_dl])
    pred_acc = float((labels == y_val).mean())
    if not (probs.shape == (cfg["n_val"], cfg["classes"])
            and np.allclose(probs.sum(1), 1.0, atol=1e-5)
            and (labels == probs.argmax(1)).all()
            and np.isfinite(val[0]) and 0.0 <= val[1][1] <= 1.0
            and abs(val[1][0] - pred_acc) <= 2.0 / cfg["n_val"]):
        fail(f"classifier evaluate {val} / predict accuracy {pred_acc}")
    steady = steps[1:]
    docs_s = statistics.median(r["docs"] / r["ms"] * 1e3 for r in steady)
    tok_s = statistics.median(r["tokens"] / r["ms"] * 1e3 for r in steady)
    ms_by_T = {}
    for r in steady:
        ms_by_T.setdefault(r["T"], []).append(r["ms"])
    emit({"phase": "classifier",
          "model": "AWD-LSTM 400-1150-3 + attention 100, fc (100,), random "
                   "weights", "vocab": len(data.stoi),
          "params": sum(p.numel() for p in model.parameters()),
          "corpus": {k: cfg[k] for k in ("n_train", "n_val", "median",
                                         "sigma", "min_len", "max_len")},
          "setup_s": setup_s,
          "bucket_counts_train": dict(sorted(collections.Counter(
              b.xs[0].shape[1] for b in epoch0).items())),
          "encoder_transfer_bit_identical": same,
          "f32_kernel_vs_loop": f32,
          "f32_tol": f"loss {LM_LOSS_RTOL} x |loss|; logits, enc_out "
                     f"and each encoder gradient of sum(enc_out x R) "
                     f"{LM_GRAD_TOL} x their largest entry",
          "dtype": "bfloat16 (autocast)", "B": B, "optimizer": "Adam2",
          "wd": cfg["wd"], "clip": cfg["clip"],
          "frozen_lr": cfg["frozen_lr"], "unfrozen_lrs": cfg["lrs"],
          "frozen_steps": frozen, "unfrozen_steps": steps,
          "encoder_unchanged_when_frozen": enc_kept,
          "longest_bucket": longest,
          "ms_per_step_by_bucket_median": {
              T: statistics.median(v) for T, v in sorted(ms_by_T.items())},
          "docs_per_s_median_2_to_12": docs_s,
          "nonpad_tokens_per_s_median_2_to_12": tok_s,
          "peak_memory_GB_unfrozen": peak / 1e9,
          "val_loss": val[0], "val_accuracy": float(val[1][0]),
          "val_auc": float(val[1][1]), "predict_accuracy": pred_acc,
          "eval_s": eval_s, "eval_docs_per_s": cfg["n_val"] / eval_s,
          "kernel_launches": launches})
    return {k: sum(v[k] for v in launches.values())
            for k in ("lstm_fwd", "lstm_bwd")}


def synthetic_ratings(rng, cfg):
    """examples/movielens.py's synthetic table, as numpy columns."""
    n, users, items = cfg["n"], cfg["users"], cfg["items"]
    u_bias = rng.normal(0, 0.5, users)
    i_bias = rng.normal(0, 0.5, items)
    u = rng.integers(0, users, n)
    i = rng.integers(0, items, n)
    r = np.clip(3.2 + u_bias[u] + i_bias[i] + rng.normal(0, 0.8, n), 0.5,
                5.0)
    return {"userId": u, "movieId": i, "rating": r.astype(np.float32)}


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def phase_collab(seed, profile=False):
    """MovieLens-shaped collaborative filtering (examples/movielens.py)."""
    import copy
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.collab import (
        CollabFilterDataObj,
        CollabFilterEnsembleNet,
        CollabFilterNet,
        ensemble_params,
    )
    from neuralnetworklibrary_tpu_torch.core.metrics import mse_loss
    from neuralnetworklibrary_tpu_torch.core.pytree import combine_preds
    from neuralnetworklibrary_tpu_torch.learner import Learner

    cfg = MOVIELENS
    rng = np.random.default_rng(seed + 41)
    t0 = time.perf_counter()
    data = CollabFilterDataObj.from_dataframes(
        synthetic_ratings(rng, cfg), "userId", "movieId", "rating",
        cfg["bs"], val_frac=cfg["val_frac"], seed=seed)
    setup_s = time.perf_counter() - t0
    n_train, n_val = len(data.train_ds), len(data.val_ds)

    # (a) one step's gradients, card against CPU
    torch.manual_seed(seed)
    model = CollabFilterNet.from_dataobj(data, cfg["emb"])
    cpu = copy.deepcopy(model).cpu()
    b = data.train_dl.peek()
    (pc, gc), (pp, gp) = card_and_cpu_grads(
        (cpu, model), [torch.from_numpy(b.xs[0]).long()],
        torch.from_numpy(b.y), mse_loss)
    grad_err = {n: rel_err(gp[n], g) for n, g in gc.items()}
    out_err = rel_err(pp, pc)
    if not (out_err <= CARD_CPU_TOL and max(grad_err.values())
            <= CARD_CPU_TOL):
        fail(f"collab card vs CPU: output {out_err}, gradients {grad_err}")
    model.zero_grad(set_to_none=True)

    # (b) fit_one_cycle(0.01, 2), and a second member for the ensemble
    members, fit_s, val0 = [], [], None
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2):
            if k:
                torch.manual_seed(seed + k)
                model = CollabFilterNet.from_dataobj(data, cfg["emb"])
            learner = Learner(tmp, data, model, "Adam2", seed=seed + k)
            if k == 0:
                val0 = learner.evaluate("val")[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learner.fit_one_cycle(cfg["lr"], cfg["epochs"], wd=cfg["wd"])
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
            members.append((learner, learner.evaluate("val")[0],
                            learner.predict("val")))
        # (c) val MSE, card against CPU, on the trained first member
        cpu = CollabFilterNet.from_dataobj(data, cfg["emb"], device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             members[0][0].model.state_dict().items()})
        cpu_val = Learner(tmp, data, cpu, "Adam2",
                          device="cpu").evaluate("val")[0]
        # (d) the 2-member ensemble net and combine_preds
        ens = CollabFilterEnsembleNet([CollabFilterNet.from_dataobj(
            data, cfg["emb"]) for _ in members])
        ens.load_state_dict(ensemble_params(
            [m[0].model.state_dict() for m in members]))
        ens_learner = Learner(tmp, data, ens, "Adam2")
        ens_val = ens_learner.evaluate("val")[0]
        ens_pred = ens_learner.predict("val")
        if profile:
            first = members[0][0]
            profile_step(lambda: first.train1minibatch(b, cfg["lr"]),
                         "collab_profile")
    combined = combine_preds([m[2] for m in members], "cont")
    y_val = data.val_ds.y
    val_mse = members[0][1]
    val_err = abs(val_mse - cpu_val) / cpu_val
    ens_err = float(np.abs(ens_pred - combined).max())
    if not val_err <= CARD_CPU_TOL:
        fail(f"collab val MSE card {val_mse} vs CPU {cpu_val}")
    if not (ens_err <= 1e-5 and abs(float(np.mean((combined - y_val) ** 2))
                                    - ens_val) <= 1e-4 * ens_val):
        fail(f"collab ensemble {ens_val} / combine_preds: |diff| {ens_err}")
    if not (np.isfinite(val_mse) and val_mse < val0):
        fail(f"collab val MSE {val0} -> {val_mse}")
    steps = cfg["epochs"] * len(data.train_dl)
    rows = cfg["epochs"] * n_train + (cfg["epochs"] + 1) * n_val
    emit({"phase": "collab", "config": "examples/movielens.py: "
          "CollabFilterNet emb 30, bs 8192, Adam2, fit_one_cycle(0.01, 2), "
          "wd 1e-4", "ratings": cfg["n"], "users": len(data.labels[0]),
          "items": len(data.labels[1]), "train_rows": n_train,
          "val_rows": n_val, "setup_s": setup_s,
          "card_vs_cpu_output_err_over_max": out_err,
          "card_vs_cpu_grad_err_over_max": max(grad_err.values()),
          "card_vs_cpu_tol": CARD_CPU_TOL,
          "val_mse_before": val0, "val_mse": val_mse,
          "val_mse_cpu": cpu_val, "val_mse_rel_err": val_err,
          "member2_val_mse": members[1][1], "ensemble_val_mse": ens_val,
          "ensemble_vs_combine_preds_max_abs_err": ens_err,
          "fit_s": fit_s[0], "steps": steps,
          "ms_per_step_incl_eval": fit_s[0] / steps * 1e3,
          "rows_per_s": rows / fit_s[0],
          "rows_counted": "epochs x train rows + (epochs + 1) x val rows "
                          "(fit_one_cycle evaluates before and after each "
                          "epoch)"})


def rossmann_arrays(rng, cfg):
    """bench.py's bench_structured table (200k rows, 20 categorical columns
    of 50 levels, 20 continuous, y) as ProcessDataFrame leaves it: codes
    1..50 (0 = unknown), continuous standardized by the train rows, y
    raw; split 0.9 / 0.1 as SplitTrainVal(seed 0)."""
    from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal

    n = cfg["n"]
    x_cat = rng.integers(1, cfg["levels"] + 1, (n, cfg["n_cat"]))
    x_cont = rng.normal(size=(n, cfg["n_cont"])).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    tr, va = SplitTrainVal(list(range(n)), val_frac=cfg["val_frac"], seed=0)
    tr, va = np.asarray(tr), np.asarray(va)
    mean, std = x_cont[tr].mean(0), x_cont[tr].std(0, ddof=1)
    x_cont = ((x_cont - mean) / std).astype(np.float32)
    return (x_cat[tr], x_cont[tr], y[tr]), (x_cat[va], x_cont[va], y[va])


def structured_data(train, val, target_type, cfg, seed):
    from neuralnetworklibrary_tpu_torch.applications.structured import (
        StructuredDataObj,
        StructuredDataset,
    )

    labels = [{"unknown": 0, **{str(i): i + 1 for i in range(cfg["levels"])}}
              for _ in range(cfg["n_cat"])]
    return StructuredDataObj(StructuredDataset(*train, target_type),
                             StructuredDataset(*val, target_type), labels,
                             None, cfg["bs"], seed=seed)


def phase_structured(seed, profile=False):
    """Rossmann-shaped tabular regression, as bench.py's bench_structured,
    and a 'cat' target at B 1024."""
    import copy
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.structured import (
        StructuredDataNet,
    )
    from neuralnetworklibrary_tpu_torch.core.metrics import (
        cross_entropy_loss,
        mse_loss,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner

    cfg = ROSSMANN
    rng = np.random.default_rng(seed + 51)
    t0 = time.perf_counter()
    train, val = rossmann_arrays(rng, cfg)
    data = structured_data(train, val, "cont", cfg, seed)
    setup_s = time.perf_counter() - t0
    torch.manual_seed(seed)
    model = StructuredDataNet.from_dataobj(data, cfg["head"])

    # (a) a train-mode forward and backward, card against CPU: the output,
    # the BatchNorm statistics it leaves and every gradient
    cpu = copy.deepcopy(model).cpu()
    b = data.train_dl.peek()
    xs = [torch.from_numpy(x) for x in b.xs]
    (oc, gc), (og, gg) = card_and_cpu_grads((cpu, model), xs,
                                            torch.from_numpy(b.y), mse_loss)
    out_err = rel_err(og, oc)
    grad_err = max(rel_err(gg[n], g) for n, g in gc.items())
    cbuf, gbuf = dict(cpu.named_buffers()), dict(model.named_buffers())
    stats_err = max(rel_err(gbuf[n].cpu().float(), v.float())
                    for n, v in cbuf.items() if "running" in n)
    if not max(out_err, grad_err, stats_err) <= CARD_CPU_TOL:
        fail(f"structured card vs CPU: output {out_err}, BatchNorm "
             f"statistics {stats_err}, gradients {grad_err}")
    model.zero_grad(set_to_none=True)
    del cpu

    # (b) one epoch, then evaluate: bench.py's rows/s including the eval
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2", seed=seed)
        learner.init_optimizer(wd=cfg["wd"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, t0 = 0, time.perf_counter()
        losses = []
        for batch in data.train_dl:
            losses.append(learner.train1minibatch(batch, cfg["lr"]))
            rows += batch.n_valid
        train_s = time.perf_counter() - t0
        val_loss = learner.evaluate("val")[0]
        rows += len(data.val_ds)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        if profile:
            profile_step(lambda: learner.train1minibatch(b, cfg["lr"]),
                         "structured_profile")

        # (c) a 'cat' target at B 1024: evaluate gives [loss, accuracy]
        edges = np.quantile(train[2], np.linspace(0, 1, cfg["classes"] + 1))
        to_cat = lambda part: (part[0], part[1], np.clip(np.searchsorted(
            edges, part[2], side="right") - 1, 0, cfg["classes"] - 1))
        cat_data = structured_data(to_cat(train), to_cat(val), "cat", cfg,
                                   seed)
        cat_data.category_labels.append(
            {i: i for i in range(cfg["classes"])})
        cat_model = StructuredDataNet.from_dataobj(
            cat_data, cfg["head"][:-1] + [cfg["classes"]])
        cat_learner = Learner(tmp, cat_data, cat_model, "Adam2", seed=seed)
        cat_learner.init_optimizer(wd=cfg["wd"])
        cat_losses = [float(cat_learner.train1minibatch(bb, cfg["lr"]))
                      for bb, _ in zip(cat_data.train_dl,
                                       range(cfg["cat_steps"]))]
        cat_val = cat_learner.evaluate("val")
        cat_ce = float(cross_entropy_loss(
            torch.from_numpy(cat_learner.predict("val", False)[0]),
            torch.from_numpy(cat_data.val_ds.y)))
    # (bench.py's y is noise independent of the inputs: nothing to learn,
    # so the losses are held finite, not falling)
    if not (all(np.isfinite(losses)) and np.isfinite(val_loss)):
        fail(f"structured losses not finite: {losses[:3]} .. "
             f"{losses[-3:]}, val {val_loss}")
    if not (len(cat_val) == 2 and 0.0 <= cat_val[1] <= 1.0
            and abs(cat_val[0] - cat_ce) <= 1e-4 * cat_ce):
        fail(f"structured 'cat' evaluate gave {cat_val} (CE of predict "
             f"{cat_ce})")
    emit({"phase": "structured",
          "config": "bench.py bench_structured: StructuredDataNet head "
                    "[1000, 500, 1], bs 1024, Adam2, wd 1e-4, lr 1e-3",
          "rows": cfg["n"], "train_rows": len(data.train_ds),
          "val_rows": len(data.val_ds),
          "emb_sizes": f"{model.n_cat} x {model.emb_sizes[0]}",
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s,
          "card_vs_cpu_output_err_over_max": out_err,
          "card_vs_cpu_bn_stats_err_over_max": stats_err,
          "card_vs_cpu_grad_err_over_max": grad_err,
          "card_vs_cpu_tol": CARD_CPU_TOL,
          "steps": len(losses), "first_losses": losses[:3],
          "last_losses": losses[-3:], "val_loss": val_loss,
          "train_s": train_s, "epoch_incl_eval_s": epoch_s,
          "ms_per_step": train_s / len(losses) * 1e3,
          "structured_rows_per_sec": rows / epoch_s,
          "peak_memory_GB": peak / 1e9,
          "cat": {"classes": cfg["classes"], "steps": cfg["cat_steps"],
                  "losses": cat_losses, "evaluate_val": cat_val,
                  "predict_ce": cat_ce}})


# --------------------------------------------------------------- detection


class CanvasLoader:
    """Batches of a dataset's images already scaled and padded to one uint8
    canvas (what BBoxDataLoader yields after its cv2 resize, with no
    jitter): Batch(xs=(uint8 NHWC,), y=(bboxes, cats), mask) over the
    loader's ``groups``, shuffled per epoch where ``shuffle``."""

    def __init__(self, ds, groups, canvas, bb, cc, bs, shuffle, seed=0):
        self.ds, self.groups = ds, [list(g) for g in groups]
        self.canvas, self.bb, self.cc = canvas, bb, cc
        self.bs, self.shuffle, self.seed, self.epoch = bs, shuffle, seed, 0

    def __len__(self):
        return len(self.groups)

    def _batch(self, g):
        from neuralnetworklibrary_tpu_torch.data.loader import Batch

        idx = np.asarray(list(g) + [g[-1]] * (self.bs - len(g)))
        mask = (np.arange(self.bs) < len(g)).astype(np.float32)
        return Batch(xs=(self.canvas[idx],), y=(self.bb[idx], self.cc[idx]),
                     mask=mask, n_valid=len(g))

    def peek(self):
        return self._batch(self.groups[0])

    def __iter__(self):
        groups = list(self.groups)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(groups)
        for g in groups:
            yield self._batch(g)
        self.epoch += 1


def detection_data(seed, tmp):
    """bench_detection's synthetic Pascal-shaped set (bench.py:518-541):
    64 images of 375 x 500, dark noise carrying 1-5 bright boxes of 20
    classes, val 0.25; each scaled by get_AspectRatioScale under ARS (512,
    1024) (nearest neighbour: no cv2 on the card's machine) and padded to
    granularity 128.  Returns (BBoxDataObj with canvas loaders, the
    (train + val) canvas, the val COCO json path)."""
    from neuralnetworklibrary_tpu_torch.applications.detection import (
        BBoxDataObj,
        _pad_u8,
        _snap_up,
        canvas_targets,
        get_transforms_bbox,
    )
    from neuralnetworklibrary_tpu_torch.applications.vision import (
        get_AspectRatioScale,
        hw_to_mm,
    )
    from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal

    D = DETECTION
    H0, W0 = D["hw"]
    rng = np.random.default_rng(seed + 60)
    ar, s = get_AspectRatioScale(H0, W0, *D["ars"])
    h, w = int(H0 * s), int(W0 * s)
    Hc, Wc = _snap_up(h, D["gran"]), _snap_up(w, D["gran"])
    tfms = get_transforms_bbox("SideOn", jitter=0, scale_range=(1, 1))
    rows = np.minimum((np.arange(h) / s).astype(np.int64), H0 - 1)
    cols = np.minimum((np.arange(w) / s).astype(np.int64), W0 - 1)
    images, pixels, anns = [], [], []
    bmax = min(80, H0 // 2, W0 // 2)
    for i in range(D["n"]):
        img = rng.integers(0, 80, (H0, W0, 3), dtype=np.uint8)
        target = []
        for _ in range(int(rng.integers(1, 6))):
            x, y = int(rng.integers(0, W0 - bmax)), int(rng.integers(
                0, H0 - bmax))
            bw, bh = int(rng.integers(bmax // 2, bmax)), int(rng.integers(
                bmax // 2, bmax))
            img[y:y + bh, x:x + bw] = rng.integers(120, 256, 3)
            cat = int(rng.integers(0, D["classes"]))
            target.append((hw_to_mm(np.asarray([x, y, bw, bh], np.float32)),
                           cat))
            anns.append({"id": len(anns), "image_id": i, "area": bw * bh,
                         "bbox": [x, y, bw, bh], "category_id": cat + 1,
                         "iscrowd": 0})
        canvas = np.broadcast_to(_pad_u8(tfms[0].stats), (Hc, Wc, 3)).copy()
        canvas[:h, :w] = img[rows][:, cols]
        pixels.append(canvas)
        images.append({"id": i, "img": f"im{i}.jpg", "target": target,
                       "aspect_ratio": ar, "scale": s})
    train, val = SplitTrainVal(list(range(D["n"])), val_frac=D["val_frac"],
                               seed=0)
    cats = {c: f"c{c + 1}" for c in range(D["classes"])}
    data = BBoxDataObj(tmp, cats, D["B"], tfms, [images[i] for i in train],
                       [images[i] for i in val], granularity=D["gran"])
    data.cat2dscat = {c: c + 1 for c in range(D["classes"])}
    canvas = np.stack([pixels[i] for i in train + val])
    for name, idx, off, shuffle in (("train", train, 0, True),
                                    ("val", val, len(train), False)):
        dl = getattr(data, name + "_dl")
        bb, cc = canvas_targets(dl.ds.images, data.max_objects, (Hc, Wc))
        setattr(data, name + "_dl", CanvasLoader(
            dl.ds, dl.groups, canvas[off:off + len(idx)], bb, cc, D["B"],
            shuffle))
    val_json = f"{tmp}/val.json"
    with open(val_json, "w") as f:
        json.dump({"images": [{"id": i, "width": W0, "height": H0}
                              for i in val],
                   "annotations": [a for a in anns if a["image_id"] in
                                   set(val)],
                   "categories": [{"id": c + 1, "name": n}
                                  for c, n in cats.items()]}, f)
    return data, canvas, val_json


def count_device_ops(fn):
    """(kernel launches, memcpy/memset ops) on the card during fn(), by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "Memcpy" in evt.key or "Memset" in evt.key:
            copies += evt.count
        else:
            kernels += evt.count
    return kernels, copies


def detection_card_vs_cpu(seed):
    """(a) retinanet18 at feature 32, 20 classes, B 2, 128 x 192, its
    output convs random: one train-mode forward and backward through the
    SSD loss on the card against the same model on the CPU, float32
    (anchors equal; reg, clas, loss within DET_CPU_TOL x max) and float64
    (also the gradients of every FPN and subnet parameter); then the
    device decode + NMS on the card against the CPU on the same reg and
    clas."""
    import copy

    from neuralnetworklibrary_tpu_torch.applications.detection import (
        ObjectDetectionNet,
        SSD_loss,
        _predict_device,
    )
    from neuralnetworklibrary_tpu_torch.ops.augment import (
        imagenet_stats,
        normalize_batch,
    )

    C = DET_CHECK
    H, W = C["hw"]
    rng = np.random.default_rng(seed + 61)
    imgs = rng.integers(0, 80, (C["B"], H, W, 3), dtype=np.uint8)
    M = 3
    bb = np.full((C["B"], M, 4), -1.0, np.float32)
    cc = np.full((C["B"], M), -1, np.int64)
    for i in range(C["B"]):
        for j in range(1 + i):
            x, y = rng.integers(0, W - 60), rng.integers(0, H - 60)
            bw, bh = rng.integers(20, 60, 2)
            imgs[i, y:y + bh, x:x + bw] = rng.integers(120, 256, 3)
            bb[i, j] = [x, y, x + bw - 1, y + bh - 1]
            cc[i, j] = rng.integers(0, C["classes"])
    x = normalize_batch(torch.from_numpy(imgs), imagenet_stats)
    y = (torch.from_numpy(bb), torch.from_numpy(cc))
    torch.manual_seed(seed)
    cpu = ObjectDetectionNet(C["classes"], backbone=C["backbone"],
                             feature_size=C["feature"], device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in (cpu.regressor, cpu.classifier):
            sub.output.weight.normal_(0, 1e-3, generator=g)
            sub.output.bias.normal_(0, 1.0, generator=g)
    res = {}
    for dtype in (torch.float32, torch.float64):
        outs = []
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(cpu).to(dev, dtype)
            anchors, reg, clas = m(x.to(dev, dtype), train=True)
            loss = SSD_loss()((anchors, reg, clas),
                              tuple(t.to(dev) for t in y))
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in m.named_parameters()
                     if n.startswith(("fpn", "regressor", "classifier"))}
            outs.append((anchors.cpu(), reg.detach().cpu(),
                         clas.detach().cpu(), loss.detach().cpu(), grads))
        (ac, rc, cc_, lc, gc), (ag, rg, cg, lg, gg) = outs
        err = {"anchors_equal": bool(torch.equal(ac.float(), ag.float())),
               "reg": float((rg - rc).abs().max() / rc.abs().max()),
               "clas": float((cg - cc_).abs().max() / cc_.abs().max()),
               "loss": float(abs(lg - lc) / abs(lc)),
               "grads": max(float((gg[n] - t).abs().max() / t.abs().max())
                            for n, t in gc.items() if t.abs().max() > 0)}
        res[str(dtype).split(".")[1]] = err
        gated = ("reg", "clas", "loss") + (("grads",) if dtype ==
                                           torch.float64 else ())
        if not err["anchors_equal"] or any(err[k] > DET_CPU_TOL
                                           for k in gated):
            fail(f"detection card vs CPU ({dtype}): {err}")
        if dtype == torch.float32:
            nms_in = (rc, cc_, ac)
    # NMS: the same f32 reg / clas through decode, threshold and NMS
    want = _predict_device(*nms_in, (H, W), top_k=1000, out_k=20,
                           return_counts=True)
    got = [t.cpu() for t in _predict_device(
        *(t.cuda() for t in nms_in), (H, W), top_k=1000, out_k=20,
        return_counts=True)]
    nms = {"kept": int((want[2] > 0).sum()),
           "classes_equal": bool(torch.equal(got[1], want[1])),
           "scores_equal": bool(torch.equal(got[2], want[2])),
           "counts_equal": bool(torch.equal(got[3], want[3])),
           "box_max_abs_err": float((got[0] - want[0]).abs().max())}
    if not (nms["classes_equal"] and nms["scores_equal"]
            and nms["counts_equal"] and nms["box_max_abs_err"] <= 1e-3
            and nms["kept"] > 0):
        fail(f"detection NMS card vs CPU: {nms}")
    emit({"phase": "detection", "part": "card vs CPU",
          "config": f"retinanet18, feature {C['feature']}, {C['classes']} "
                    f"classes, random output convs, B {C['B']}, {H} x {W}, "
                    "train mode, SSD_loss",
          "err_over_max": res,
          "tol": f"{DET_CPU_TOL} x max: float32 reg, clas, loss; float64 "
                 "also every FPN and subnet gradient (TF32 off)",
          "nms": nms, "nms_tol": "classes, scores, counts equal; boxes "
                                 "1e-3 px"})


def detection_bench(seed, profile=False):
    """(b) bench_detection's configuration through the port's
    ObjectDetectionLearner (retinanet50, feature 256, 20 classes, B 8,
    Adam2, wd 1e-4, clip 1.0, lr 1e-4, bf16 autocast) on the synthetic set:
    10 steps on one batch, evaluate('val', [SSD_RegLoss, SSD_ClasLoss]),
    predict('val', thresh 0.05, max_boxes 20) with NMS on the device,
    compute_mAP and coco_pascal_eval (the C++ helper built here); then the
    canvas installed as the device cache: cached train steps and cached
    predict."""
    import tempfile

    from neuralnetworklibrary_tpu_torch.applications.detection import (
        ObjectDetectionLearner,
        SSD_ClasLoss,
        SSD_RegLoss,
        retinanet50,
    )
    from neuralnetworklibrary_tpu_torch.ops import boxes as box_ops

    D = DETECTION
    B = D["B"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data, canvas, val_json = detection_data(seed, tmp)
        setup_s = time.perf_counter() - t0
        torch.manual_seed(seed)
        model = retinanet50(D["classes"])
        learner = ObjectDetectionLearner(tmp, data, model, "Adam2", seed=seed)
        learner.init_optimizer(wd=D["wd"], clip=D["clip"])
        batch = data.train_dl.peek()
        n_anchors = int(model.anchors_for(batch.xs[0].shape[1:3],
                                          "cuda").shape[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(learner, batch, D["lr"], D["steps"])
        peak = torch.cuda.max_memory_allocated()
        train = step_report(losses, secs, B, peak)
        host_loop = loader_steps(learner, list(data.train_dl), D)
        lf = learner.loss_func
        t0 = time.perf_counter()
        val = learner.evaluate("val", [SSD_RegLoss(lf), SSD_ClasLoss(lf)])
        eval_s = time.perf_counter() - t0
        if not (np.isfinite(val[0]) and np.isfinite(val[1]).all()):
            fail(f"detection evaluate gave {val}")
        n_val = len(data.val_ds)

        def predict(thresh=0.05):
            return learner.predict("val", thresh=thresh, max_boxes=20)

        def timed_predict(thresh=0.05, reps=3):
            """The last output and the median seconds of ``reps`` calls."""
            secs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = predict(thresh)
                secs.append(time.perf_counter() - t0)
            return out, statistics.median(secs)

        def check(out, least):
            """Per image at most 20 boxes (at least ``least``), finite,
            inside the original image, scores descending."""
            pb, _, cs = out
            n = [len(c) for c in cs]
            H0, W0 = D["hw"]
            ok = (len(pb) == n_val and all(least <= k <= 20 for k in n)
                  and all(c == sorted(c, reverse=True) for c in cs)
                  and all(np.isfinite(b).all() and (b >= 0).all()
                          and b[2] <= Wc / s + 1e-3 and b[3] <= Hc / s + 1e-3
                          for bs in pb for b in bs))
            if not ok:
                fail(f"detection predict: boxes per image {n}")
            return n

        Hc, Wc = batch.xs[0].shape[1:3]
        s = data.val_ds.images[0]["scale"]
        predict()                                     # warm-up
        torch.cuda.reset_peak_memory_stats()
        out, pred_s = timed_predict()
        pred_peak = torch.cuda.max_memory_allocated()
        n_boxes = check(out, 0)
        if any(min(c) <= 0.05 for c in out[2] if c):
            fail("detection predict kept a score <= thresh 0.05")
        # thresh 0: every top-k candidate enters the NMS (its full load)
        predict(0.0)
        full, full_s = timed_predict(0.0)
        check(full, 1)
        preds = list(zip(*full))
        # device operations of one predict batch, and of its NMS alone
        xs, _, _ = learner._to_device(data.val_dl.peek())
        hw = xs[0].shape[1:3]
        nms_ops, sweeps, pred_ops = {}, {}, {}
        with torch.no_grad():
            fwd_ops = count_device_ops(lambda: learner._eval_forward(xs))
            anchors, reg, clas = learner._eval_forward(xs)
            for th in (0.05, 0.0):
                nms_in = _nms_inputs(reg, clas, anchors, hw, th)
                nms_ops[th] = count_device_ops(lambda: box_ops.batched_nms(
                    *nms_in, top_k=1000, out_k=20))
                sweeps[th] = box_ops.last_sweeps
                pred_ops[th] = count_device_ops(lambda: learner.predictor(
                    hw, reg, clas, anchors, th, max_boxes=20))
        t0 = time.perf_counter()
        m_ap = learner.compute_mAP(preds, thresholds=[0.5])
        m_ap_coco = learner.compute_mAP(preds)
        map_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = learner.coco_pascal_eval(val_json, preds)
        coco_s = time.perf_counter() - t0
        if not (0.0 <= m_ap <= 1.0 and 0.0 <= m_ap_coco <= 1.0
                and len(stats) == 12 and np.isfinite(stats).all()):
            fail(f"detection mAP {m_ap}, {m_ap_coco}, COCO stats {stats}")
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, D["lr"]),
                         "detection_profile")
            profile_step(predict, "detection_predict_profile")

        # the device cache: the same canvases on the card
        learner.install_device_cache(canvas, include_val=True)
        cached_loop = loader_steps(learner, list(data.train_dl), D)
        if profile:
            cb = data.train_dl.peek()
            profile_step(lambda: learner.train1minibatch(cb, D["lr"]),
                         "detection_cached_profile")
        predict()                                     # warm-up
        cout, cpred_s = timed_predict()
        check(cout, 0)
        predict(0.0)
        cfull, cfull_s = timed_predict(0.0)
        check(cfull, 1)
    emit({"phase": "detection", "part": "bench_detection",
          "config": "bench.py bench_detection: retinanet50, feature 256, "
                    "20 classes, ObjectDetectionLearner, Adam2, wd 1e-4, "
                    "clip 1.0, lr 1e-4",
          "dtype": "bfloat16 (autocast)", "B": B,
          "images": f"{D['n']} synthetic {D['hw'][0]} x {D['hw'][1]}, "
                    f"val {D['val_frac']}; ARS {D['ars']}, granularity "
                    f"{D['gran']}",
          "canvas": list(batch.xs[0].shape[1:3]), "anchors": n_anchors,
          "setup_s": setup_s, "steps": D["steps"], **train,
          "val": {"loss": val[0], "SSD_RegLoss": float(val[1][0]),
                  "SSD_ClasLoss": float(val[1][1]), "eval_s": eval_s,
                  "images": n_val},
          "predict": {"images": n_val, "seconds_median_of_3": pred_s,
                      "img_per_s": n_val / pred_s,
                      "peak_memory_GB": pred_peak / 1e9,
                      "boxes_per_image": n_boxes,
                      "thresh_0": {"seconds": full_s,
                                   "img_per_s": n_val / full_s},
                      "device_ops_per_batch": {
                          "forward": list(fwd_ops),
                          **{f"thresh_{th}": {
                              "decode_nms_fetch": list(pred_ops[th]),
                              "batched_nms": list(nms_ops[th]),
                              "nms_sweeps": sweeps[th]} for th in (0.05,
                                                                   0.0)},
                          "as": "[kernel launches, memcpy/memset]"}},
          "mAP_on": "predict('val', thresh 0)",
          "mAP_pascal": m_ap, "mAP_coco_thresholds": m_ap_coco,
          "mAP_s": map_s, "coco_stats": [float(v) for v in stats],
          "coco_eval_s": coco_s,
          "host_loader_steps": host_loop,
          "cached": {**cached_loop,
                     "predict_seconds_median_of_3": cpred_s,
                     "predict_img_per_s": n_val / cpred_s,
                     "predict_thresh_0_img_per_s": n_val / cfull_s,
                     "canvas_GB": canvas.nbytes / 1e9}})


def loader_steps(learner, batches, D):
    """D['steps'] train1minibatch calls cycling over ``batches``, each
    synchronised: losses (finite), ms of each, and img/s of the median of
    steps 2-10."""
    losses, ms = [], []
    for i in range(D["steps"]):
        t0 = time.perf_counter()
        losses.append(float(learner.train1minibatch(
            batches[i % len(batches)], D["lr"])))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all():
        fail(f"detection train losses {losses}")
    steady = statistics.median(ms[1:])
    return {"losses": losses, "ms_per_step": ms,
            "ms_per_step_median_2_to_10": steady,
            "train_img_per_s": D["B"] / steady * 1e3}


def _nms_inputs(reg, clas, anchors, hw, thresh):
    """_predict_device's decode and threshold, to count its NMS alone."""
    from neuralnetworklibrary_tpu_torch.ops.boxes import decode_boxes

    boxes = decode_boxes(reg, anchors, hw)
    scores = clas.amax(-1)
    return boxes, clas.argmax(-1), torch.where(scores > thresh, scores,
                                               torch.zeros_like(scores))


def phase_detection(seed, profile=False):
    detection_card_vs_cpu(seed)
    detection_bench(seed, profile)


# ----------------------------------------------------- packed Qwen3-0.6B


def qwen3_state_dict(seed, n_layers):
    """An HF Qwen3ForCausalLM state dict (tied, so no lm_head) with random
    weights from ``seed``, on the card: matrices normal(0, 0.02) (HF's
    initializer_range), norm scales 1."""
    c = QWEN3
    D, H, Hkv, hd, F_ = (c["d_model"], c["n_heads"], c["n_kv_heads"],
                         c["head_dim"], c["d_ff"])
    g = torch.Generator("cuda").manual_seed(seed)

    def normal(*shape):
        return torch.empty(shape, device="cuda").normal_(0, 0.02,
                                                         generator=g)

    def ones(n):
        return torch.ones(n, device="cuda")

    sd = {"model.embed_tokens.weight": normal(c["vocab_size"], D),
          "model.norm.weight": ones(D)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": normal(H * hd, D),
                   p + "self_attn.k_proj.weight": normal(Hkv * hd, D),
                   p + "self_attn.v_proj.weight": normal(Hkv * hd, D),
                   p + "self_attn.o_proj.weight": normal(D, H * hd),
                   p + "self_attn.q_norm.weight": ones(hd),
                   p + "self_attn.k_norm.weight": ones(hd),
                   p + "mlp.gate_proj.weight": normal(F_, D),
                   p + "mlp.up_proj.weight": normal(F_, D),
                   p + "mlp.down_proj.weight": normal(D, F_),
                   p + "input_layernorm.weight": ones(D),
                   p + "post_attention_layernorm.weight": ones(D)})
    return sd


def qwen3_model(seed, n_layers, **kw):
    """Qwen3-0.6B's widths at ``n_layers`` through the port's load_qwen3
    (the converter a user calls), packed rows on (reset_at = eos)."""
    from neuralnetworklibrary_tpu_torch.utils.llama_convert import (
        load_qwen3,
    )

    c, t = QWEN3, QWEN3_TRAFFIC
    arch = {k: c[k] for k in ("n_heads", "d_model", "vocab_size",
                              "head_dim", "n_kv_heads", "d_ff", "rope_base",
                              "norm_eps")}
    model, _ = load_qwen3(qwen3_state_dict(seed, n_layers), n_layers,
                          max_len=t["T"], reset_at=t["eos"], device="cuda",
                          **arch, **kw)
    return model


def qwen3_rows(rng, n_rows):
    """(x, y) packed rows (n_rows, T) int32 of synthetic documents:
    log-normal lengths (median 512, sigma 1.0, clipped to [8, 4095]) of
    tokens drawn Zipf-like (rank r with weight 1 / (r + 1)**1.1, ranks on
    a random permutation of the ids below the eos), each closed by the
    eos, packed first-fit-decreasing by data.packing.pack_documents, pad
    a dedicated id; the rows shuffled."""
    from neuralnetworklibrary_tpu_torch.data.packing import pack_documents

    t = QWEN3_TRAFFIC
    ids = rng.permutation(t["eos"])
    w = 1.0 / np.arange(1, t["eos"] + 1) ** 1.1
    cdf = np.cumsum(w / w.sum())
    need = n_rows * t["T"]
    lengths = []
    while sum(lengths) < 1.05 * need:
        lengths.append(int(np.clip(np.exp(np.log(t["median"])
                                          + t["sigma"] * rng.normal()),
                                   t["min_len"], t["max_len"])))
    tokens = ids[np.minimum(np.searchsorted(cdf, rng.random(sum(lengths))),
                            t["eos"] - 1)]
    docs = np.split(tokens, np.cumsum(lengths)[:-1])
    x, y, _ = pack_documents(docs, t["T"], t["eos"], pad_token=t["pad"])
    if len(x) < n_rows:
        fail(f"qwen3 data: {len(x)} packed rows < {n_rows}")
    order = rng.permutation(len(x))[:n_rows]
    return x[order], y[order]


def qwen3_starts(x):
    """(B, T) int32 document starts of packed rows (each segment starts
    right after an eos), as TransformerLM(reset_at=eos) derives them."""
    sep = np.zeros(x.shape, bool)
    sep[:, 1:] = x[:, :-1] == QWEN3_TRAFFIC["eos"]
    idx = np.arange(x.shape[1])
    return np.maximum.accumulate(np.where(sep, idx, 0), axis=1).astype(
        np.int32)


def qwen3_f32_checks(seed, x, y):
    """(a) the 2-layer copy at full width, float32: flash path against
    einsum path on two packed rows (loss and every gradient), and each
    of three documents of row 0 alone against its place in the row."""
    from neuralnetworklibrary_tpu_torch.nn.transformer import (
        PackedSeqCrossEntropyLoss,
    )

    t = QWEN3_TRAFFIC
    model = qwen3_model(seed, 2, flash_attention=True)
    loss_fn = PackedSeqCrossEntropyLoss(t["pad"])
    xb = torch.from_numpy(x[:2]).long().cuda()
    yb = torch.from_numpy(y[:2]).long().cuda()
    res = []
    for flash in (True, False):
        model.flash_attention = flash
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(xb, train=True), yb)
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
        fail(f"qwen3 f32 flash vs einsum loss: |err| {loss_err} > 1e-4")
    if not g_err <= 1e-3 * g_max:
        fail(f"qwen3 f32 flash vs einsum grads: max|err| {g_err} > 1e-3 x "
             f"max|grad| {g_max}")
    # packed against standalone: the first document, one in the middle
    # and the last real one (a one-token document where there is one)
    starts = qwen3_starts(x[:1])[0]
    real = int((x[0] != t["pad"]).sum())
    bounds = sorted(set(starts[:real].tolist()))
    ends = bounds[1:] + [real]
    single = [i for i in range(len(bounds)) if ends[i] - bounds[i] == 1]
    picks = sorted({0, len(bounds) // 2, len(bounds) - 1,
                    *(single[:1])})
    with torch.no_grad():
        packed = model(xb[:1])[0][0]
        doc_err, scale = 0.0, float(packed.abs().max())
        for i in picks:
            s, e = bounds[i], ends[i]
            alone = model(xb[:1, s:e])[0][0]
            doc_err = max(doc_err, float((packed[s:e] - alone).abs().max()))
    if not doc_err <= 1e-4 * max(1.0, scale):
        fail(f"qwen3 packed vs standalone logits: max|err| {doc_err} > "
             f"1e-4 x max|logit| {scale}")
    del model
    torch.cuda.empty_cache()
    return {"f32_flash_vs_einsum_loss_abs_err": loss_err,
            "f32_flash_vs_einsum_grad_max_abs_err": g_err,
            "f32_grad_max_abs": g_max,
            "f32_tol": "loss 1e-4, grads 1e-3 x max|grad|",
            "packed_vs_standalone": {
                "docs": [{"start": bounds[i], "len": ends[i] - bounds[i]}
                         for i in picks],
                "max_abs_err": doc_err, "max_abs_logit": scale,
                "tol": "1e-4 x max(1, max|logit|)"}}


def phase_qwen3(seed, profile=False):
    """Packed Qwen3-0.6B pretraining (HF Qwen/Qwen3-0.6B config.json
    widths, random weights through load_qwen3): (a) qwen3_f32_checks; (b)
    the full 28 layers, bf16, B 4 x T 4096 packed rows through the
    Learner (ArrayDataset / DataLoader, PackedSeqCrossEntropyLoss of the
    pad id, Adam2), 10 steps on successive batches, then evaluate over 2
    batches, with exact K1-K3 launches; (c) the same model with
    fused_ce=True: its chunked CE against the materialised CE on one
    batch, then 3 steps with FusedSeqCrossEntropyLoss, and both peak
    memories."""
    import tempfile
    import types

    from neuralnetworklibrary_tpu_torch.data.loader import (
        ArrayDataset,
        DataLoader,
    )
    from neuralnetworklibrary_tpu_torch.learner import Learner
    from neuralnetworklibrary_tpu_torch.nn.transformer import (
        FusedSeqCrossEntropyLoss,
        PackedSeqCrossEntropyLoss,
    )
    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
    from neuralnetworklibrary_tpu_torch.ops.chunked_ce import (
        chunked_softmax_ce,
        dense_softmax_ce,
    )

    c, t = QWEN3, QWEN3_TRAFFIC
    B, L, T = t["B"], c["n_layers"], t["T"]
    rng = np.random.default_rng(seed + 31)
    n_train, n_val = B * t["steps"], B * t["eval_batches"]
    x, y = qwen3_rows(rng, n_train + n_val)
    checks = qwen3_f32_checks(seed, x, y)

    t0 = time.perf_counter()
    model = qwen3_model(seed, L, flash_attention=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    data = types.SimpleNamespace(
        target_type="lang_model", bs=B,
        train_dl=DataLoader(ArrayDataset(x[:n_train], y[:n_train]), B,
                            prefetch=0),
        val_dl=DataLoader(ArrayDataset(x[n_train:], y[n_train:]), B,
                          prefetch=0))
    counted = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2",
                          loss_func=PackedSeqCrossEntropyLoss(t["pad"]),
                          seed=seed, compute_dtype="bfloat16")
        learner.init_optimizer(wd=t["wd"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        losses, secs, real = [], [], []
        for batch in data.train_dl:
            t0 = time.perf_counter()
            losses.append(learner.train1minibatch(batch, t["lr"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            real.append(int((batch.y != t["pad"]).sum()))
        peak = torch.cuda.max_memory_allocated()
        val_loss = learner.evaluate("val")[0]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        if profile:
            profile_step(lambda: learner.train1minibatch(batch, t["lr"]),
                         "qwen3_profile", focus=("flash_",))
        losses = [float(v) for v in losses]
        want = {"flash_fwd": L * (t["steps"] + t["eval_batches"]),
                "flash_bwd_dq": L * t["steps"],
                "flash_bwd_dkv": L * t["steps"]}
        if launches != want:
            fail(f"qwen3 flash kernel launches {launches} != {want}")
        if not (all(np.isfinite(losses)) and np.isfinite(val_loss)
                and max(losses[-3:]) < losses[0]):
            fail(f"qwen3 losses not finite and falling: {losses}, val "
                 f"{val_loss}")
        steady = statistics.median(secs[1:])
        out["train"] = {
            "losses": losses, "val_loss": val_loss,
            "first_step_ms": secs[0] * 1e3,
            "ms_per_step_median_2_to_10": steady * 1e3,
            "tokens_per_s": B * T / steady,
            "non_pad_tokens_per_s": statistics.median(
                r / s for r, s in zip(real[1:], secs[1:])),
            "non_pad_share": sum(real) / (len(real) * B * T),
            "peak_memory_GB": peak / 1e9, "kernel_launches": launches}
        del learner
    torch.cuda.empty_cache()

    # (c) fused CE: the chunked CE against the materialised one on a batch,
    # then 3 steps through the Learner
    model.fused_ce = True
    batch = data.train_dl.peek()
    xb = torch.from_numpy(batch.xs[0]).long().cuda()
    yb = torch.from_numpy(batch.y).long().cuda()
    with torch.no_grad():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            h, head = model(xb)
        fused = float(chunked_softmax_ce(h.float(), head.float(), yb))
        dense = float(dense_softmax_ce(h.float(), head.float(), yb))
        del h
    if not abs(fused - dense) <= 1e-5 * abs(dense):
        fail(f"qwen3 chunked CE {fused} vs materialised {dense}")
    with tempfile.TemporaryDirectory() as tmp:
        learner = Learner(tmp, data, model, "Adam2",
                          loss_func=FusedSeqCrossEntropyLoss(), seed=seed,
                          compute_dtype="bfloat16")
        learner.init_optimizer(wd=t["wd"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f_losses, f_secs = timed_steps(learner, batch, t["lr"],
                                       t["fused_steps"])
        f_peak = torch.cuda.max_memory_allocated()
        del learner
    model.fused_ce = False
    if not all(np.isfinite(f_losses)):
        fail(f"qwen3 fused CE losses {f_losses}")
    out["fused_ce"] = {"chunk": 8192, "loss_on_batch": fused,
                       "materialised_loss_on_batch": dense,
                       "rel_err": abs(fused - dense) / abs(dense),
                       "tol": "1e-5 relative", "losses": f_losses,
                       "ms_per_step": [s * 1e3 for s in f_secs],
                       "peak_memory_GB": f_peak / 1e9}
    del model
    torch.cuda.empty_cache()
    emit({"phase": "qwen3",
          "model": "Qwen3-0.6B (HF Qwen/Qwen3-0.6B config.json), random "
                   "weights through load_qwen3", **c, "params": n_params,
          "setup_s": setup_s, **checks,
          "traffic": {k: t[k] for k in ("B", "T", "median", "sigma",
                                        "min_len", "max_len", "eos", "pad",
                                        "lr", "wd")},
          "dtype": "bfloat16 (autocast)", "optimizer": "Adam2",
          "steps": t["steps"], "eval_batches": t["eval_batches"], **out})
    return launches


def qwen3_flash_timing(seed):
    """K1-K3 at the Qwen3 path's attention (bf16, B 4, T 4096, H 16 (the
    8 kv heads expanded), hd 128, causal) with the q_start of its packed
    rows, beside the plain version, the same kernels without q_start (the
    whole causal triangle) and, as a yardstick the port never calls, SDPA
    with its memory-efficient backend pinned and the block-diagonal causal
    boolean mask.  The bound counts the attended pairs of these rows."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
        reference_flash_attention,
    )

    c, t = QWEN3, QWEN3_TRAFFIC
    B, T, H, hd = t["B"], t["T"], c["n_heads"], c["head_dim"]
    rng = np.random.default_rng(seed + 32)
    x, _ = qwen3_rows(rng, B)
    starts = qwen3_starts(x)
    qs = torch.from_numpy(starts).cuda()
    pairs = H * int((np.arange(T)[None] - starts + 1).sum())
    q, k, v, do = flash_case(rng, B, T, H, hd, torch.bfloat16)
    scale = 1.0 / hd ** 0.5
    timer = Timer()
    rows = {}
    for label, kw in (("packed", dict(qs=qs)), ("causal", {})):
        o, lse = flash_fwd(q, k, v, scale, **kw)
        delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
                 .reshape(B * H, T).contiguous())
        rows[label] = {
            "flash_fwd": timer.stats(lambda: flash_fwd(q, k, v, scale,
                                                       **kw)),
            "flash_bwd_dq": timer.stats(lambda: flash_bwd_dq(
                q, k, v, do, lse, delta, scale, **kw)),
            "flash_bwd_dkv": timer.stats(lambda: flash_bwd_dkv(
                q, k, v, do, lse, delta, scale, **kw))}
    plain_fwd, plain_bwd, _ = sdpa_fwd_bwd(
        timer, lambda a, b, cc: reference_flash_attention(
            a, b, cc, scale, q_start=qs), (q, k, v), do, None)
    pos = torch.arange(T, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] >= qs.long()[:, :, None]))[:, None]
    lib_fwd, lib_bwd, lib_check = sdpa_fwd_bwd(
        timer, lambda a, b, cc: F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), cc.transpose(1, 2),
            attn_mask=mask).transpose(1, 2),
        (q, k, v), do, SDPBackend.EFFICIENT_ATTENTION)
    out = {}
    for name, st in rows["packed"].items():
        fwd = name == "flash_fwd"
        out[name] = timed_row(st, plain_fwd if fwd else plain_bwd,
                              lib_fwd if fwd else lib_bwd,
                              flash_bound(B, T, H, hd, name, pairs=pairs,
                                          extra=B * T * 4))
        out[name]["causal_without_q_start_ms"] = rows["causal"][name]["ms"]
        emit({"phase": "timing", "kernel": name, "shape": "qwen3_packed",
              "B": B, "T": T, "H": H, "hd": hd, "dtype": "bfloat16",
              "causal": True, "q_start": "packed rows of qwen3_rows",
              "attended_pairs": pairs,
              "pairs_share_of_causal": pairs / (B * H * T * (T + 1) / 2),
              "design": FLASH_DESIGN[name], **out[name],
              "plain": "reference_flash_attention(q_start=) in bf16"
                       + ("" if fwd else ": its backward, dq dk dv together"),
              "library": "F.scaled_dot_product_attention(attn_mask= the "
                         "block-diagonal causal bool mask), backend "
                         "EFFICIENT_ATTENTION, "
                         + ("forward" if fwd else
                            "backward, dq dk dv together")
                         + " (yardstick only)",
              **({} if fwd else {"library_bwd_check": lib_check}),
              "share_of_bound": out[name]["bound_ms"] / out[name]["ms"]})
    return out

def tc_smem_bytes(hd, tile, stages, n_stationary):
    """Shared memory of a tensor-core flash kernel (TcSmem in the source)."""
    halves = hd // 64
    return (n_stationary * halves * 128 * 128 + stages * 2 * halves * tile
            * 128 + 8 * (1 + 2 * stages) + 1024)


def dkv_smem_bytes(hd, q_tile, groups, stages, opt):
    """Shared memory of the tensor-core K3 (DkvSmem in the source): k and v
    of 64 * groups rows, the ring of q and dO tiles, each stage's lse,
    delta and document starts and, with the options, its float32 bias
    tile."""
    halves, rows = hd // 64, 64 * groups
    ring = 2 * halves * rows * 128 + stages * 2 * halves * q_tile * 128
    bias = stages * q_tile * rows * 4 if opt else 0
    return ring + bias + stages * 3 * q_tile * 4 + 8 * (1 + 3 * stages) + 1024


SMEM_LIMIT = 232448               # bytes a block may use (227 KB)
K12_NAMES = ("kKeyTile", "kFwdStages", "kDqStages")
K3_NAMES = ("kDkvQTile{hd}", "kDkvGroups{hd}", "kDkvStages{hd}",
            "kDkvProducerRegs{hd}")
K12_VARIANTS = ((128, 3, 3), (64, 2, 2), (128, 2, 2), (64, 4, 4))
# K3 (query tile, consumer warpgroups, ring depth, the producer's
# registers under setmaxnreg or 0 for none), set at hd 64 and 128
K3_VARIANTS = ((32, 2, 3, 0), (32, 2, 3, 72), (32, 2, 2, 72), (64, 2, 2, 72),
               (64, 2, 2, 88), (64, 2, 3, 80), (64, 1, 2, 0), (32, 1, 3, 0))


def phase_tile_sweep(seed):
    """K1 and K2 built with other key-tile widths and ring depths, and K3
    with other query-tile widths, consumer warpgroups and ring depths, each
    timed at the GPT-2 and T5-encoder shapes at hd 64 and hd 128 (12 and 6
    heads): the measurement behind the constants kKeyTile, kFwdStages,
    kDqStages and kDkv* of csrc/flash_attention.cu (K3 at the T5 shape
    with dbias).  Each variant is an edited copy of the source, built into
    _build/ and loaded in place of the shipped library for its timing
    only.  Variants that do not fit in shared memory are listed, not
    timed; each line carries its variant's ptxas registers and spills."""
    import ctypes
    import shutil
    import subprocess as sp

    from neuralnetworklibrary_tpu_torch.kernels import build
    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa

    src = (build.CSRC / "flash_attention.cu").read_text()

    def shipped_value(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    shipped12 = tuple(shipped_value(n) for n in K12_NAMES)
    shipped3 = {hd: tuple(shipped_value(n.format(hd=hd)) for n in K3_NAMES)
                for hd in (64, 128)}
    # a variant: (family, label, {constant: value}); the shipped source
    # first, under the family "shipped"
    variants = [("shipped", "shipped", {})]
    variants += [("k1k2", "k1k2_%d_%d_%d" % v, dict(zip(K12_NAMES, v)))
                 for v in K12_VARIANTS if v != shipped12]
    variants += [("k3", "k3_%d_%d_%d_r%d" % v,
                  {n.format(hd=hd): x for hd in (64, 128)
                   for n, x in zip(K3_NAMES, v)})
                 for v in K3_VARIANTS]
    procs = {}
    for family, label, consts in variants[1:]:
        d = build.BUILD / f"sweep_{label}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(build.CSRC / "hopper.cuh", d / "hopper.cuh")
        text = src
        for n, new in consts.items():
            line = f"constexpr int {n} = {shipped_value(n)};"
            if text.count(line) != 1:
                fail(f"tile sweep: {line!r} is not in the source once")
            text = text.replace(line, f"constexpr int {n} = {new};")
        (d / "flash_attention.cu").write_text(text)
        procs[label] = sp.Popen([build.nvcc(), *build.FLAGS, "-o",
                                 str(d / "lib.so"),
                                 str(d / "flash_attention.cu")],
                                stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    libs = {"shipped": build.bind("flash_attention", fa.SIGNATURES)}
    reports = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"tile sweep variant {label} did not build:\n{log[-3000:]}")
        libs[label] = build.declare(ctypes.CDLL(str(
            build.BUILD / f"sweep_{label}" / "lib.so")), fa.SIGNATURES)
        reports[label] = {k: r for k, r in ptxas_report(log).items()
                          if "_tc_kernel" in k}

    # the backward kernels' inputs come from the shipped K1
    rng = np.random.default_rng(seed + 13)
    timer = Timer()
    shapes = {}
    for hd in (64, 128):
        H = 768 // hd
        for name, B, T, opt, kw in (
                ("gpt2", 8, 1024, (0, 0.0, 0), dict(causal=True)),
                ("t5", 16, 512, (0, 0.1, 77), dict(causal=False))):
            q, k, v, do = flash_case(rng, B, T, H, hd, torch.bfloat16)
            if name == "t5":
                kw["bias"] = torch.from_numpy(rng.standard_normal(
                    (H, T, T), dtype=np.float32) * 0.5).cuda()
                kw["kvm"] = additive_mask((torch.arange(T)[None, :]
                                           < torch.from_numpy(rng.integers(
                                               384, T + 1, B))[:, None])
                                          .cuda())
            o, lse = fa.flash_fwd(q, k, v, hd ** -0.5, *opt, **kw)
            delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
                     .reshape(B * H, T).contiguous())
            shapes[f"{name}_hd{hd}"] = ((q, k, v, do, lse, delta,
                                         hd ** -0.5), opt, kw)

    def k12_times(var, args, opt, kw, hd):
        q, k, v = args[:3]
        tile, fs, ds = var
        return {"flash_fwd": timer.stats(lambda: fa.flash_fwd(
                    q, k, v, args[-1], *opt, **kw))
                if tc_smem_bytes(hd, tile, fs, 1) <= SMEM_LIMIT
                else "does not fit in shared memory",
                "flash_bwd_dq": timer.stats(lambda: fa.flash_bwd_dq(
                    *args, *opt, **kw))
                if tc_smem_bytes(hd, tile, ds, 2) <= SMEM_LIMIT
                else "does not fit in shared memory"}

    def k3_times(var, args, opt, kw, hd):
        with_bias = kw.get("bias") is not None
        if dkv_smem_bytes(hd, *var[:3], with_bias or opt[1] > 0) > SMEM_LIMIT:
            return {"flash_bwd_dkv": "does not fit in shared memory"}
        if with_bias:
            return {"flash_bwd_dkv_dbias": timer.stats(
                lambda: fa.flash_bwd_dkv_dbias(*args, *opt, **kw))}
        return {"flash_bwd_dkv": timer.stats(
            lambda: fa.flash_bwd_dkv(*args, *opt, **kw))}

    for family, label, consts in variants:
        with kernel_library("flash_attention", libs[label]):
            times = {}
            for shape, (args, opt, kw) in shapes.items():
                hd = args[0].shape[3]
                times[shape] = {}
                if family in ("shipped", "k1k2"):
                    var12 = tuple(consts.get(n, shipped12[i])
                                  for i, n in enumerate(K12_NAMES))
                    times[shape].update(k12_times(var12, args, opt, kw, hd))
                if family in ("shipped", "k3"):
                    var3 = tuple(consts.get(n.format(hd=hd), shipped3[hd][i])
                                 for i, n in enumerate(K3_NAMES))
                    times[shape].update(k3_times(var3, args, opt, kw, hd))
                    times[shape]["k3_variant"] = var3
            emit({"phase": "tile_sweep", "variant": label,
                  "constants": consts or "as shipped",
                  "shipped": family == "shipped", "times_ms": times,
                  "ptxas": reports.get(label, "as in the build phase")})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel of a serve "
                         "run and of a train step of each model (senet154 "
                         "and ViT-B/16 among them)")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="also time K5 at other split counts and warps, "
                         "K1, K2 and K3 built with other tile widths, "
                         "warpgroups and ring depths, and K6/K7 at every "
                         "cluster size and in ablations")
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
    edge_err = phase_flash_edges(args.seed)
    adam_err, adam_rows = phase_adam(args.seed)
    launches = phase_serve(args.seed, args.profile)
    flash_launches = adam_counted("train", phase_train, args.seed,
                                  args.profile)
    adam_counted("auto_flash", phase_auto_flash, args.seed)
    lstm_err = phase_lstm_kernel(args.seed)
    lstm_launches = adam_counted("lm", phase_lm, args.seed, args.profile)
    t5_err = phase_flash_options(args.seed)
    t5_launches = adam_counted("t5", phase_t5, args.seed, args.profile)
    adam_counted("vision", phase_vision, args.seed, args.profile)
    vit_launches = adam_counted("vit", phase_vit, args.seed, args.profile)
    clf_launches = adam_counted("classifier", phase_classifier, args.seed,
                                args.profile)
    adam_counted("collab", phase_collab, args.seed, args.profile)
    adam_counted("structured", phase_structured, args.seed, args.profile)
    adam_counted("detection", phase_detection, args.seed, args.profile)
    qwen3_launches = adam_counted("qwen3", phase_qwen3, args.seed,
                                  args.profile)
    k5_rows = phase_timing(args.seed)
    flash_t = phase_flash_timing(args.seed)
    lstm_t = phase_lstm_timing(args.seed)
    t5_t = phase_t5_timing(args.seed)
    vit_t = phase_vit_timing(args.seed)
    qwen3_t = qwen3_flash_timing(args.seed)
    if args.tile_sweep:
        phase_paged_sweep(args.seed)
        phase_tile_sweep(args.seed)
        phase_lstm_sweep(args.seed)
    # K5: the numbers at the serving path's own shape, and every timing
    # row beside them
    t = k5_rows["slice"]
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "design": K5_DESIGN, "replaces": REPLACES, "launches": launches,
        "launches_counted": "one per wrapper call: paged_split_kernel, "
                            "whose last block per (slot, head group) "
                            "merges the splits",
        "max_abs_err": main_err, "max_err": main_err,
        "tol": TOL[torch.bfloat16], "shape": "slice", "splits": t["splits"],
        **{k: t[k] for k in TIMED_KEYS},
        "by_shape": {label: {k: r[k] for k in ("splits", *TIMED_KEYS,
                                               "library_full_strip_ms")}
                     for label, r in k5_rows.items()}}]
    # K1-K3: the numbers at the GPT-2 train shape, and at the T5 encoder's,
    # the ViT's and the packed Qwen3 path's beside them; launches over the
    # four training paths.  K4 runs on the T5 path alone.
    for name in FLASH_KERNELS:
        by_path = {"train": flash_launches.get(name, 0),
                   "t5": t5_launches[name],
                   "vit": vit_launches.get(name, 0),
                   "qwen3": qwen3_launches.get(name, 0)}
        dbias = name == "flash_bwd_dbias"
        row = t5_t[name] if dbias else flash_t[name]
        tol = (DBIAS_TOL if dbias else FLASH_TOL)[torch.bfloat16]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "design": FLASH_DESIGN[name], "replaces": FLASH_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **({"launches_counted": "one per K3 pass that emits dS (also "
                                    "counted in flash_bwd_dkv), each with "
                                    "one batch-sum launch"} if dbias else {}),
            "max_abs_err": (max(t5_err[name], edge_err[name]) if dbias else
                            max(flash_err[name], t5_err[name],
                                edge_err[name])),
            "tol": ("atol %g x max|ref| + rtol %g + bf16 delta slack"
                    if dbias else "atol %g + rtol %g") % tol,
            "shape": "t5_encoder" if dbias else "gpt2_train", **row,
            **({} if dbias else {"t5_encoder": t5_t[name],
                                 "vit": vit_t[name],
                                 "qwen3_packed": qwen3_t[name]})})
    for name, row in lstm_t.items():
        kind = name.split("_")[1]
        by_path = {"lm": lstm_launches[name],
                   "classifier": clf_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": LSTM_SOURCE,
            "design": LSTM_DESIGN, "replaces": LSTM_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": lstm_err[name],
            "tol": "atol %g + rtol %g" % LSTM_TOL[kind], **row})
    # the fused Adam step: a kernel of the port alone, at Qwen3-0.6B's
    # trained elements with the SDAR stage's beside them; launches and
    # elements over every training path
    kernels.append({
        "name": "adam", "route": "cuda", "source": ADAM_SOURCE,
        "design": ADAM_DESIGN, "replaces": ADAM_REPLACES,
        "launches": sum(r["launches"] for r in ADAM_PATHS.values()),
        "launches_by_path": {p: r["launches"] for p, r in ADAM_PATHS.items()},
        "elements_by_path": {p: r["elements"] for p, r in ADAM_PATHS.items()},
        "launches_counted": "one per (layer group, step count) table of at "
                            "most 80 tensors",
        "max_abs_err": adam_err, "tol": "atol %g + rtol %g" % ADAM_TOL[::-1],
        "shape": "qwen3_0.6b",
        **{k: adam_rows["qwen3_0.6b"][k] for k in TIMED_KEYS},
        "sdar_30b_a3b": {k: adam_rows["sdar_30b_a3b"][k]
                         for k in TIMED_KEYS}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
