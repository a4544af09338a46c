#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aline_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result lines; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — builds every CUDA kernel from ``aline_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main paths' shapes (the GMM pair also at the
             continuous path's B=200 and 5, T=2), with timings.
             Forward: rtol = atol = 1e-4 (float32 accuracy on both
             sides: TF32 is off in
             PyTorch, the kernels' D x F products are 3xTF32; the
             summation order differs).  Backward: also against
             ``torch.autograd.grad`` of the
             two-einsum formula, within 1e-4 of each element plus 1e-4 of
             the gradient's largest element (the weight gradients sum up to
             40,200 rows, in per-CTA partials and then over CTAs, where
             the plain version sums in another order), on inputs whose
             pre-activations are exact (``gmm_inputs(grid=True)``: else a
             pre-activation within rounding of 0 flips the relu mask
             between two summation orders); two calls on the same inputs
             must agree bitwise (no atomics).  Every kernel's ``ms`` is the
             eager calls' time, the wrapper's host work included (as the
             paths call them), with ``device_ms``, the kernel alone from a
             CUDA graph of the calls, beside it; plain and library times
             are eager.  A GMM row's ``bound_ms`` is the lesser of its two
             forms' bounds: every FLOP on float32 FMAs (``fma_bound_ms``,
             the bound of the first, all-FMA kernels), or the D x F
             products as 3xTF32 on the tensor cores (three TF32 products
             at 495 TFLOP/s) and the rest on FMAs (``tc_bound_ms``); each
             against the bytes.
3c. flash kernels — the plan of the role mask (``flash_plan``) bitwise
             equal to its plain version, and the role-masked flash attention
             forward and backward, which walk it, against their plain
             versions at the eval (B=100, H=4, N=2103; compared on its first
             8 batch rows, timed at full B), late eval (the same with 31
             scattered context points, the most pairs the eval reaches),
             training (B=200, N=303), burning (N=133), ragged (N=37, rows
             that see no key, a time column) and dh=64 (B=4, H=8, N=2048)
             shapes, and forward alone at phase 21b's BED traces (B=200,
             H=4: N=2003 unsharded, N=704 a rank's of 3; 8 rows compared):
             forward ``close()`` at 1e-4, backward ``grads_close()``
             against the plain version and against autograd through the
             plain forward (where every row sees a key), bitwise equal over
             two calls.  Times as in phase 3.  Library yardstick:
             SDPA with the boolean mask, and its autograd backward.  The
             bound counts the (row, key) pairs that the batch's mask needs
             (``score_pairs``), the pairs the kernels score; the bound over
             all N² pairs stands beside it.  Last, a flash forward and
             backward at the training shape under
             ``torch.cuda.set_sync_debug_mode("error")``: the plan, the
             kernels and their wrappers never wait for the host.
3d. bf16 flash kernels — the bf16 forms of the flash forward and
             backward at every shape of 3c and the data-parallel ones
             (``BF16_FLASH_CASES``; the plain backward checked on 8 batch
             rows at the eval shapes) against their plain versions in
             bf16 on the card: O and dQ
             within one bf16 ulp of each element plus 1e-5 (O) or 1e-4 (dQ)
             of the largest, dK and dV plus (blocks + 1) * 2^-8 of the
             largest (the plain version sums them into bf16 block by block
             of block_q rows, as the TPU kernel does; the kernel sums in
             float32 and rounds once), lse 1e-4; and dK, dV against the
             plain version summed as the kernel sums them (over all rows in
             float32, rounded once: ``per_block=False``) within one ulp plus
             1e-4 of the largest element; backward bitwise repeatable.
             Times as in 3c; bytes at 2 an element of q, k, v, O, dO, dQ,
             dK, dV and 4 of lse and D; the products of two bf16 operands
             (q·kᵀ, dO·vᵀ) at the bf16 tensor cores' 989 TFLOP/s, those
             with a float32 operand (p, dS) the lesser of two forms: on
             FMAs at 67 (``fma_bound_ms``) or as three bf16 products each
             at 989 (``tc_bound_ms``), as the kernels run them; library:
             SDPA in bf16.
3e. fold kernel — ``loc_eig_fold`` (the EIG fold of location finding,
             one chunk a launch) against its plain version at the BED
             cell's chunk (B=200, Th=35, Lc=9,586 draws, and the last
             chunk's 3,056): each logsumexp within 1e-5 plus (Th + 8)
             float32 ulps of its size, two calls bitwise equal; kernel,
             device and plain ms of a chunk against the chunk's share of
             the bound (``eig_fold_bound``, special-function results);
             a whole batch's fold at L=1e6 (the draws included, 105
             launches) against the batch's bound.  The same for
             ``ces_eig_fold`` (the EIG fold of CES) at the CES cell's
             chunk (B=100, Th=16, Lc=32,768, and the last chunk's 5,760),
             each logsumexp within ``ces_fold_tolerance``, and a batch at
             L=1e7 (306 launches) against ``ces_fold_bound``.
wide. al1d_wide128 (``aline_tpu_torch.config.WIDE128_RECIPE``,
             assets/al1d_wide128_config.json: d=1024, 8 heads of 128,
             F=4096, C=10, 3 layers, flash; PR 15), after phase 3d.
             (a) Every kernel at its shapes, against its plain version:
             the GMM forward at the eval pool (B=100, T=2001) and the
             training targets (B=200, T=102), the backward at the
             training targets, each within WIDE_TOL (1e-4) of the
             largest element, the plain and library forms run over
             WIDE_CHUNK_B batch rows at a time; the flash pair as 3c and
             3d at ``wide_eval`` [100, 8, 2103, 128] (forward) and
             ``wide_train`` [200, 8, 303, 128], the bf16 backward's dQ
             and dK also allowed what one ulp of each row's rounded D
             moves them by (``delta_rounding``); an odd width through
             the padding (D=96, F=200 as 128, 256; dh=24 as 32).  (b)
             ``train``'s main on the recipe, 1 burning and 2 main epochs
             at B=50 (WIDE_TRAIN_CUT), f32 (both GMM kernels, the f32
             flash pair) and bf16 (the bf16 flash pair): launches per
             epoch, warm epoch, peak; one card step against one CPU step
             at full width (f32 under phase 7's limits but the GMM head's
             ill-determined relu masks, WIDE_MASK_BAND; bf16 under 7c's).
             (c) ``eval_al``'s main on the f32 run's weights at B=100,
             n_query=2000, T=30, three strategies, in bf16, and in f32 at
             B=WIDE_F32_EVAL_B (launches, curves, wall); the kernel path
             held to the no-kernel path (compact, fused_gmm=off) on
             WIDE_HOLD_B rows:
             f32 as 4b, bf16 as 4d (the two bf16 paths' mean curve gap at
             most the no-kernel path's from f32).  The kernels line gains each
             kernel at these shapes (``"case": "al1d_wide128"``).
Phases 4, 4b, 5, 6, 6b, 7 and 7b compute in float32 (``dtype=float32``
pinned), as before the port followed the run's dtype.

4. slice   — the flagship GP-AL-1D eval (checkpoints/al1d_200k, weights
             from the committed npz): a B=100, n_query=2000 GP batch and
             the three-strategy T=30 active-learning rollout through
             ``compare_strategies``, with the kernel launch counts.
4b. flash slice — the same batch through the flagship's params with
             ``encoder.attention_impl=flash`` (a copy of its config.json
             in the output directory, through ``load_model``): 279 flash, 93 plan
             and 186 GMM launches, finite curves, aline improves.  Against the
             compact path on the card: forwards along its aline trajectory
             within 5e-4, rows that choose alike within 1e-4, and a row
             that chooses differently does so at a tie (log-probs within
             1e-3); the compact path on the CPU (its first 25 rows) is
             held to the same and reported beside flash as the witness of
             how many rows leave a tie by rounding alone.
4c. bf16 slice — the flagship at its own dtype, bf16, compact (``auto``),
             on the same batch: 93 GMM forwards (the pool, 2001 tokens;
             the target sets take the bf16 einsums), finite curves, aline
             improves; device busy time under the profiler.  Held against
             the port on the CPU in bf16 over 8 rows along the CPU's
             trajectory (``hold_trajectory``: limits BF16_CARD_SHARE,
             BF16_CARD_ULPS, BF16_TIE_ULPS); exact and near ties counted.
             Control: phase 4's float32 card path read the same way must
             fail BF16_CARD_SHARE.
4d. bf16 flash slice — the same with ``attention_impl=flash``: 279 bf16
             flash forwards and 93 plans; held the same way against the
             flash path on the CPU (2 rows), and against 4c: flash keeps
             the scores in float32 where compact rounds them to bf16, so
             the two bf16 paths' mean |log-prob difference| may not exceed
             that of compact in bf16 against compact in float32 (phase 4).
5. parity  — a small batch through the slice on the CPU (plain versions)
             and on the card (kernels): curves within 1e-4, same indices.
6. train   — the GP-AL-1D training recipe (B=200, n_query_init=200,
             T=30, f32, rollout_remat) from a fresh flax-equal init through
             ``Trainer``: 2 burning and 3 main epochs, with the launch
             counts of both kernels per epoch, the warm epoch time,
             rollouts/s and peak device memory.
6b. flash train — the same recipe with ``encoder.attention_impl=flash``,
             2 burning and 2 main epochs: per epoch 6T flash forward, 3T
             flash backward and 2T plan launches beside the GMM counts.
7. train parity — one optimizer step from the flagship's params on the
             CPU (plain versions) and on the card (kernels): a B=4,
             n_query=16, T=5 batch with a fixed mask and the same Gumbel
             noise; same designs, the losses within 1e-4, the gradients
             within 1e-4 of each element plus 1e-4 of the largest, and the
             updated params within 1e-4 wherever the two devices' gradients
             agree to 1% (see ``train_step_parity``).
6c. bf16 train — the recipe in bf16 (``bench.py``'s dtype), compact and
             flash, 2 burning and 2 main epochs each: no GMM launch (the
             token sets have 102 tokens, ``fused_gmm=auto``), per epoch 2T
             plans, 6T bf16 flash forwards and 3T backwards with flash.
7b. flash + time-token step parity — the same check for a fresh model
             from the seed with ``encoder.with_time_token=true
             time_token=true encoder.attention_impl=flash``.
7c. bf16 step parity — one bf16 step on the card against one on the CPU:
             the flagship (compact), a fresh flash model with the time
             token, and the flagship with ``head.fused_gmm=on`` (both GMM
             kernels on the bf16 path); same designs, losses within 1e-3
             of the loss's scale, each parameter's gradient within a
             relative L2 error of BF16_GRAD_RTOL.

8. bed     — ``python -m aline_tpu_torch.eval_bed`` (its ``main``) on
             checkpoints/loc_100k, weights from the committed npz, in its
             bf16, at ``scripts/eval_bed.py``'s full protocol (M=2000,
             B=200, n_query=2000, T=34, L=1e6, seed 0) with the random
             baseline: per-step sPCE and sNMC (mean ± SE) of both; the
             final sPCE within BED_SIGMAS combined standard errors of the
             JAX package's bounds at the same protocol on a TPU
             (``benchmarks/artifacts``; bound values, not times); nmc >=
             pce - 1e-5 in every row and step; one ``loc_eig_fold`` launch
             a chunk of the bounds and no other kernel (no other of the
             path's shapes takes one); wall time split into the
             rollout and the EIG stage, the EIG stage per batch against
             its bounds (``eig_fold_bound``), peak memory, and the device
             busy share and top kernels of one batch.
8b. bed witness — a full-size batch's greedy bf16 traces on the card
             against the port on the CPU over 8 rows, held as 4c; the
             bounds on 20,000 CPU-drawn thetas within 1e-4 of the CPU's,
             final and stepwise; and one bound on the card's own draws
             (L=1e5, four chunks) under
             ``torch.cuda.set_sync_debug_mode("error")``.
9. train loc — ``python -m aline_tpu_torch.train`` (its ``main``) with the
             recipe of loc_100k's config.json (B=200, T=30, bf16, fresh
             init) and ``eval.EIG=true``: 2 burning and 3 main epochs; the
             in-training bounds once, at the config's eval.L=50000,
             M=2000, batch_size=1000, finite in metrics.jsonl; the final
             per-step bounds at eval.*_final with M_final cut to 200; one
             ``loc_eig_fold`` launch a chunk of the bounds and no other
             kernel; warm epoch, the hook's wall and peak memory.

Phases 10-13 run the remaining tasks of the paper on their banked
checkpoints, in their bf16, through the entry points; no kernel lies on
these paths but CES's EIG fold (``ces_eig_fold``, one launch a chunk of
the bounds), and each phase checks that no other was launched:

10. ces bed — ``eval_bed``'s ``main`` on checkpoints/ces_200k at the JAX
             run's protocol (T=15, L=1e7, n_query=2000, batch 100, seed 0)
             with the random baseline, M cut to CES_SMOKE_M=200 (named in
             its log line; ``--ces-M 2000`` runs the full protocol): the
             final sPCE of both within SIGMAS combined standard errors of
             the JAX package's at M=2000 on a TPU (the port's SEs are its
             own), nmc >= pce - 1e-5 in every row and step, one
             ``ces_eig_fold`` launch a chunk; the rollout against the EIG
             stage, that stage per batch against its fused bound
             (``ces_fold_bound``), peak memory.
10b. ces witness — the censored log-density card vs CPU in both tail
             modes on a grid of limits with |z| up to 200, values inside
             and outside (tolerance as tests/test_torch_ces.py holds the
             port to JAX); the CES bounds of card traces on 20,000
             CPU-drawn thetas card vs CPU within 1e-5 relative plus what
             float32 rounding may move the log-likelihoods by
             (``ces_loglik_rounding``); one chunk's peak memory; one bound
             under ``torch.cuda.set_sync_debug_mode("error")``; one
             ``ces_eig_fold`` launch a chunk of the card's bounds.
11. psych   — ``eval_psychometric`` and ``eval_psi`` (``main``) on
             checkpoints/psych_100k (B=100, n_query=300, T=30, seeds 0, 1,
             2, three masks): each final mean LL and RMSE over the 300
             rows within SIGMAS combined standard errors of the JAX
             package's (benchmarks/artifacts/psych_r4_100k_curves.npz,
             psych_psi_curves.npz; read with numpy); eval_psi's peak
             memory at its default ``--b-chunk 4`` under PSI_PEAK_LIMIT;
             two-step PSI and random rollouts under
             set_sync_debug_mode("error").
12. hpo     — ``eval_hpo`` (``main``) on the six checkpoints/hpo_* runs
             (the fixed test set, T=30, n_query=100, n_target=100): the
             policy's final mean LL and RMSE within SIGMAS combined
             standard errors of the run's JAX curves; the rows whose curve
             leaves the artifact's by more than the step-0 rounding gap,
             and by how much.
13. train tasks — ``train``'s ``main`` on the ces (EIG hook once),
             psychometric (predefined masks) and hpo (rpart) recipes in
             bf16, B=200, 2 burning and 3 main epochs: finite losses, warm
             epoch ms, peak memory; one ``ces_eig_fold`` launch a chunk of
             CES's bounds.

Phases 14-18 run the paper's baselines and the remaining design paths
through their entry points; 16 lies on the GMM kernels, and the bounds of
location finding in 16-18 on ``loc_eig_fold`` (one launch a chunk):

14. gp      — ``eval_al --with-gp-baselines`` on al1d_200k at
             scripts/eval_al.py's protocol (n_query=500, T=30, 80 fit
             steps, all six methods in one stacked fit), B cut to
             GP_SMOKE_B (named in its log line; ``--only gp`` runs B=100):
             finite curves, each deterministic method's final RMSE below
             its step 0's, the wall and peak memory; the card against the
             CPU on GP_WITNESS with fixed random scores (curves within
             1e-3 while the choices agree, a row that leaves does so at a
             relative score gap within GP_TIE_REL); two steps under
             ``set_sync_debug_mode("error")``.
15. bench   — ``eval_al --benchmark`` forrester, gramacy1d, higdon on
             al1d_200k in bf16 (n_query=500): finite curves, aline's
             RMSE falls; the card against the CPU over 8 rows along the
             CPU's trajectory (``hold_trajectory``, phase 4c's limits,
             candidates below BENCH_NEGLIGIBLE_P read apart).
16. cont    — ``train_continuous``'s ``main`` at its DEFAULTS (location
             finding, B=200, T=30, f32), 2 burning and 3 main epochs,
             REINFORCE and pathwise (``alpha=0 alpha_pce=1 pce_L=255``):
             exactly 60 GMM forwards and 30 backwards an epoch, T
             forwards a greedy batch; final bounds at L=1e7, M=200, nmc >=
             pce - 1e-5, one fold launch a chunk; one step card vs CPU held
             at PARITY_T steps and
             at T=30, the card's REINFORCE reward the CPU's.
17. dad     — ``train_dad``'s ``main`` at its DEFAULTS for DAD_EPOCHS
             epochs: no kernel but the fold's, one launch a chunk of the
             final bounds at L=1e6, M=200; epochs/s, peak memory; one step
             card vs CPU as in 16.
18. trend   — ``eval_bed_trend``'s ``main`` on loc_100k (bf16, M=200,
             batch 100, n_query=2000, L = 1e4, 1e5, 1e6): nmc >= pce -
             1e-5 at every L, the L=1e6 row bit for bit
             ``eval_eig_from_history``'s on the same traces and seed; no
             kernel but the fold's, one launch a chunk.

Phases 19-21 run the multi-process paths: their ranks are processes of
one spawn (DIST_WORLD gloo ranks that share cuda:0: NCCL cannot put two
ranks on one card), each line naming the backend and device of each
rank; any rank's failure fails the phase.

19. dp      — ``Trainer`` with ``mesh_data`` at bench.py's recipe
             (TRAIN_ARGS: B=200, n_query_init=200, T=30): (a) one f32 step
             through the all-reduces under NCCL at world size 1 within
             1e-6 of the largest gradient of the step without them; (b) on
             2 gloo ranks (the third takes no part) one f32 step on 100
             rows each, its grads within phase 7's tolerance of the
             one-process step and equal on both ranks, the parameters
             bitwise equal after 3 epochs, then 2 burning and 2 main bf16
             epochs with the GMM pair (fused_gmm=on) and the bf16 flash
             pair: launches per rank (60 GMM forwards, 30 backwards, 60
             plans, 180 and 90 flash calls a main epoch), warm epoch ms
             and peak memory per rank; (c) where two cards are visible,
             (b)'s step and epochs again under NCCL, one card a rank.
             Then the trainer's settings: one f32 step with
             ``remat_policy=dots`` against ``full`` (fused_gmm=on, and with
             flash) within phase 7's tolerance, their peak memory and
             time (the second of two runs each); a
             3-epoch run with ``profile_dir`` in a temporary directory (the
             trace of epoch 2, its size, that it names gmm_head_fwd); one
             epoch with ``debug_nans=true`` raising nothing.
20. mesh    — one batch of loc_100k at the full protocol (B=200,
             n_query=2000, T=34, L=1e6, bf16 traces): the per-step bounds
             on the 1-D contrastive mesh of 2 ranks and on the (2,1) and
             (1,2) eval meshes within 1e-5 of the single process's on the
             same traces and seed; the fold's time per rank; n_chunks
             fold launches over the contrastive ranks, on each data rank.
21. seq     — loc_100k's greedy traces (B=200, the full 2001-token pool
             over 3 ranks, T=34, bf16) against the unsharded rollout on
             the card: a row may leave its choices only where the
             unsharded bf16 design scores of the two candidates lie within
             BF16_TIE_ULPS; the rollout's wall time.
21b. seq, flash — the same with ``attention_impl=flash`` (a copy of the
             run's config.json): each rank launches exactly 34 plans and
             102 bf16 flash forwards (as the unsharded rollout does) and
             keeps the unsharded flash choices but at ties, as 21; the
             walls; a float32 control on SEQ_F32_ROWS rows, reported.

Phases 22-24 run the demo run and its recipe, and the host
loader of HPO-B; no kernel lies on their paths:

22. demo    — ``eval_al``'s ``main`` on checkpoints/al1d_5k_demo (its
             weights through ``BANKED_RUNS``, bf16) at the seed study's
             protocol (data mask, B=200, T=30, n_query=500, seed 0):
             aline's final LL within SIGMAS combined standard errors of
             the study's seed-8 row (al1d_r3_final_eval_seed_variance.npz);
             the card held to the CPU over DEMO_WITNESS_ROWS rows as in 4c.
23. demo_train — ``train``'s ``main`` on the demo recipe
             (``seed_study.DEMO_RECIPE``) cut to DEMO_SHORT: straight to 30
             epochs, and stopped at 20 and resumed to 30; the resumed
             parameters' distance from the straight run's, finite losses
             on both sides of the burning switch, epoch ms of both phases,
             peak memory, ``scripts/plateau_report.py`` on the run.
24. hpob    — ``csrc/hpob_loader.cpp`` built by g++ here; on the six
             meta-train files the native arrays bit for bit the json
             path's; both timed.

Phase 25 runs the AL rollout as one CUDA graph:

25. graph   — ``al_rollout_curves`` on al1d_200k (bf16) through its CUDA
             graph against its eager steps (``al_curves._rollout``), at
             the live experiment's shape (B=1, n_query=200, T=30, aline)
             and at the eval's (B=100, n_query=2000, T=30, aline): a
             rollout's host-clock ms to its curves on the host (median of
             GRAPH_REPS batches), eager and replayed; the capture's one-off
             cost (the key's first call, whose eager pass is its result,
             less an eager call); the device operations a
             ``torch.profiler`` trace of one eager rollout and of one
             replay shows; each replay's curves bitwise the eager ones.
             Then the training rollout's graphs (``train/graph.py``) at
             the training cells' shape (B=200, n_query=200, T=30, the data
             mask) under ``compact`` and ``flash``: two trainers from one
             state, one eager (``train/rollout.py`` in ``loop.rollout``),
             one through the graphs, TRAIN_GRAPH_EPOCHS epochs each; an
             epoch's host-clock ms to its loss on the host (median of the
             epochs after the first), the first graphed epoch's (eager
             epoch and capture), the device operations of one eager and one
             replayed epoch, peak memory, and the losses, gradients and
             parameters of every epoch bitwise the eager ones.

``--only bed train_loc ces psych hpo train_tasks bench cont dad trend gp
demo demo_train hpob graph dp mesh seq`` runs phase 1 and the named ones of
8-25 alone (bed: 8 and 8b; train_loc: 9; seq: 21 and 21b; no kernels line);
``--only kernels`` runs phases 1-3e and prints the kernels line, its
launches null (no main path ran); ``--only fold`` runs 3e alone and
prints its row; ``--only wide`` runs phase wide and prints its rows of
the kernels line (with ``wide_kernels``, (a) alone, launches null); with
no arguments it runs every phase.

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
import argparse
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "checkpoints" / "al1d_200k"
OUT_DIR = ROOT / "chiprun_out"
TOL = 1e-4
# Phase 4b's fixed limits (their readings are in PERF.md).  Design
# probabilities and posterior means of the flash and compact paths, on
# the same inputs: FWD_TOL; the compact path alone moves them by ~1e-4
# between the CPU and the card.  A design choice whose two candidates'
# log-probs lie within TIE is a tie at float32 precision: neighbouring
# pool points of a 1-D domain score almost alike.
FWD_TOL = 5e-4
TIE = 1e-3
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense TF32
# and bf16 on the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
T_STEPS, BATCH, N_QUERY = 30, 100, 2000
# the GP-AL-1D training recipe (bench.py, train.py's docstring)
TRAIN_ARGS = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
              "task.n_query_init=200", "batch_size=200", "min_T=30", "T=30",
              "rollout_remat=true", "burning_epoch=2", "max_epoch=5",
              "checkpoint=0", "verbose=1000", "dtype=float32"]
FLASH_TRAIN_ARGS = ["encoder.attention_impl=flash", "max_epoch=4"]
# bench.py's production dtype, 2 burning and 2 main epochs
BF16_TRAIN_ARGS = ["dtype=bfloat16", "max_epoch=4"]
TIME_FLASH_ARGS = ["encoder.attention_impl=flash",
                   "encoder.with_time_token=true", "time_token=true"]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


WALLS = {}      # phase: wall seconds of the run (``timed``)


def timed(name, fn, *args):
    """``fn(*args)``, its wall time logged and kept in WALLS."""
    t0 = time.perf_counter()
    out = fn(*args)
    WALLS[name] = time.perf_counter() - t0
    log("wall", f"{name}: {WALLS[name]:.1f} s")
    return out


def time_ms(fn, reps=5, iters=10):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, reps=5, iters=10):
    """Median over ``reps`` of the mean device time of ``iters`` calls of
    ``fn``, captured in one CUDA graph and replayed between CUDA events:
    the kernels' time without the host's launch work."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def close(got, ref):
    """(max abs error, max error relative to |ref|, within tolerance)."""
    err = (got - ref).abs()
    ok = bool((err <= TOL + TOL * ref.abs()).all())
    rel = (err / ref.abs().clamp_min(1e-30)).max().item()
    return err.max().item(), rel, ok


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("device", f"{torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from aline_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build()
    seconds = time.perf_counter() - t0
    for name, path in paths.items():
        log("build", f"{name}: {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log("build", f"  {line.strip()}")
    log("build", f"built {len(paths)} kernel(s) in {seconds:.2f} s")
    return seconds


def gmm_inputs(B, T, seed, D=32, F=128, C=10, grid=False):
    """Random head inputs at the flagship widths.  ``grid`` puts z, W1 and
    b1 on a dyadic grid (z in steps of 1/8 up to 1, W1 and b1 in steps of
    1/128 up to 1/8): every pre-activation is then exact in any summation
    order, so the relu mask, a step function of it, is the same in the
    kernel and in a reference that sums in another order."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def steps(*shape, n, step):
        return torch.randint(-n, n + 1, shape, generator=g,
                             device="cuda").float() * step

    if grid:
        return (steps(B, T, D, n=8, step=1 / 8),
                steps(C, D, F, n=16, step=1 / 128),
                steps(C, F, n=16, step=1 / 128),
                randn(C, F, 3, std=F ** -0.5), randn(C, 3, std=0.1))
    return (randn(B, T, D), randn(C, D, F, std=D ** -0.5),
            randn(C, F, std=0.1), randn(C, F, 3, std=F ** -0.5),
            randn(C, 3, std=0.1))


def phase_kernels():
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    # the continuous-design path: the 2 theta tokens of location finding
    # at B=200 (training, phase 16) and at its greedy eval's batch
    # (eval.batch_size_final's default, 5)
    shapes = [(BATCH, N_QUERY + 1, "pool"), (BATCH, 102, "targets"),
              (200, 102, "train targets"), (3, 37, "ragged"),
              (200, 2, "continuous train"), (5, 2, "continuous greedy"),
              # a data-parallel training step's targets on each of 2 ranks
              (100, 102, "dp train targets")]
    rows, worst = {}, 0.0
    for seed, (B, T, what) in enumerate(shapes):
        args = gmm_inputs(B, T, seed)
        got = ghk.gmm_head_fwd(*args)
        torch.cuda.synchronize()
        ref = ghk.gmm_head_fwd_plain(*args)
        abs_err, rel_err, ok = close(got, ref)
        if not ok:
            raise AssertionError(f"gmm_head_fwd disagrees with its plain "
                                 f"version at B={B} T={T}: max abs "
                                 f"{abs_err:.3e}, max rel {rel_err:.3e}")
        worst = max(worst, abs_err)
        z, w1, b1, w2, b2 = args
        C, D, F = w1.shape
        row = dict(
            B=B, T=T, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=time_ms(lambda: ghk.gmm_head_fwd(*args)),
            device_ms=device_ms(lambda: ghk.gmm_head_fwd(*args)),
            plain_ms=time_ms(lambda: ghk.gmm_head_fwd_plain(*args)),
            # the two-einsum formula, timed as the library yardstick
            library_ms=time_ms(lambda: torch.einsum(
                "btcf,cfo->btco", torch.relu(
                    torch.einsum("btd,cdf->btcf", z, w1) + b1), w2) + b2),
            **gmm_fwd_bound(B, T, D, F, C))
        rows[what] = row
        log("kernels", f"gmm_head_fwd {what} B={B} T={T}: max abs err "
            f"{abs_err:.3e}, max rel err {rel_err:.3e}; kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, two-einsum "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; FMA bound {row['fma_bound_ms']:.4f} ms)")
    return rows, worst


def split_bound(t_fma, t_tc, flops, nbytes):
    """The least time of a kernel's two forms, each against the bytes:
    ``t_fma`` seconds of operations with its float32 products on FMAs
    (``fma_bound_ms``), ``t_tc`` with them on the tensor cores
    (``tc_bound_ms``)."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = min(t_fma, t_tc)
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                fma_bound_ms=max(t_fma, t_bytes) * 1e3,
                tc_bound_ms=max(t_tc, t_bytes) * 1e3,
                flops=flops, bytes=nbytes)


def gmm_bound(mma_flops, other_flops, nbytes):
    """A GMM kernel's bound: its D x F products (``mma_flops``) as 3xTF32
    on the tensor cores (three TF32 products each), or every FLOP on
    FMAs."""
    t_other = other_flops / PEAK_F32_FLOPS
    return split_bound(mma_flops / PEAK_F32_FLOPS + t_other,
                       3 * mma_flops / PEAK_TF32_FLOPS + t_other,
                       mma_flops + other_flops, nbytes)


def gmm_fwd_bound(B, T, D, F, C):
    """The forward's ``gmm_bound``: its FLOPs and bytes as
    ``portbench/counts/gmm_head.py`` counts them, of which the D x F
    products are 2·B·T·C·D·F."""
    from portbench.counts.gmm_head import fwd_bytes, fwd_flops
    mma = 2 * B * T * C * D * F
    return gmm_bound(mma, fwd_flops(B, T, D, F, C) - mma,
                     fwd_bytes(B, T, D, F, C))


def bf16_flash_bound(bf16_flops, f32_flops, nbytes):
    """A bf16 flash kernel's bound: its products of two bfloat16 operands
    (``bf16_flops``: q·kᵀ, and dO·vᵀ in the backward) at the bf16 tensor
    cores' rate with float32 sums, and those with a float32 operand
    (``f32_flops``: p or dS) on FMAs or, as the kernels run them, as three
    bfloat16 products each on the tensor cores."""
    t_bf16 = bf16_flops / PEAK_BF16_FLOPS
    return split_bound(t_bf16 + f32_flops / PEAK_F32_FLOPS,
                       t_bf16 + 3 * f32_flops / PEAK_BF16_FLOPS,
                       bf16_flops + f32_flops, nbytes)


def grads_close(got, ref):
    """(max abs error, within tolerance) for a gradient: 1e-4 of each
    element plus 1e-4 of the gradient's largest element."""
    err = (got - ref).abs()
    scale = ref.abs().max()
    ok = bool((err <= TOL * ref.abs() + TOL * scale).all())
    return err.max().item(), ok


def phase_kernels_bwd():
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    names = ("dz", "dw1", "db1", "dw2", "db2")
    shapes = [(200, 102, "train targets"), (200, 201, "train pool"),
              (3, 37, "ragged"), (200, 2, "continuous train"),
              (100, 102, "dp train targets")]
    rows, worst = {}, 0.0
    for seed, (B, T, what) in enumerate(shapes):
        z, w1, b1, w2, b2 = gmm_inputs(B, T, 10 + seed, grid=True)
        C, D, F = w1.shape
        g = torch.randn(B, T, C, 3, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(20 + seed))
        got = ghk.gmm_head_bwd(z, w1, b1, w2, g)
        again = ghk.gmm_head_bwd(z, w1, b1, w2, g)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"gmm_head_bwd is not deterministic at "
                                 f"B={B} T={T}")
        plain = ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)
        leaves = [t.clone().requires_grad_() for t in (z, w1, b1, w2, b2)]
        out = torch.einsum("btcf,cfo->btco", torch.relu(torch.einsum(
            "btd,cdf->btcf", leaves[0], leaves[1]) + leaves[2]),
            leaves[3]) + leaves[4]
        lib = torch.autograd.grad(out, leaves, g, retain_graph=True)
        errs = {}
        for name, a, p, r in zip(names, got, plain, lib):
            for ref_name, ref in (("plain", p), ("autograd", r)):
                err, ok = grads_close(a, ref)
                if not ok:
                    raise AssertionError(
                        f"gmm_head_bwd {name} disagrees with {ref_name} at "
                        f"B={B} T={T}: max abs {err:.3e}")
                errs[f"{name} vs {ref_name}"] = err
        abs_err = max(errs.values())
        worst = max(worst, abs_err)
        n = B * T
        nbytes = 4 * (2 * n * D + n * 3 * C + 2 * (w1.numel() + b1.numel()
                                                   + w2.numel()) + 3 * C)
        row = dict(
            B=B, T=T, max_abs_err=abs_err, errors=errs,
            ms=time_ms(lambda: ghk.gmm_head_bwd(z, w1, b1, w2, g)),
            device_ms=device_ms(lambda: ghk.gmm_head_bwd(z, w1, b1, w2, g)),
            plain_ms=time_ms(lambda: ghk.gmm_head_bwd_plain(z, w1, b1, w2,
                                                            g)),
            # the backward of the two-einsum formula by autograd
            library_ms=time_ms(lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True)),
            **gmm_bound(n * C * 6 * D * F, n * C * 12 * F, nbytes))
        rows[what] = row
        log("kernels", f"gmm_head_bwd {what} B={B} T={T}: max abs err "
            f"{abs_err:.3e} (vs plain and autograd), bitwise repeatable; "
            f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), "
            f"plain {row['plain_ms']:.4f} ms, autograd {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; FMA bound "
            f"{row['fma_bound_ms']:.4f} ms)")
    return rows, worst


# Phase wide: al1d_wide128's head (D=1024, F=4096, C=10) at its eval pool
# and its training targets, and an odd width that reaches the tiled kernel
# through the padding (D=96, F=200 run as 128, 256).  The plain forward
# would build a [B, T, C, F] tensor of 32.8 GB at the pool, so the plain
# and library versions run over WIDE_CHUNK_B batch rows at a time, the
# whole batch in turn (their times are those of the whole loop).  Sums
# over D=1024, F=4096 and, in dz, C·F = 40,960 terms (20,400 rows in dW1
# and dW2) run in another order than the einsums', both in float32 (TF32
# off for the plain side, 3xTF32 in the kernels): √40960 · 2^-24 ≈ 1.2e-5
# of the sum of |terms|, several times the largest output.  WIDE_TOL of
# each output's largest element, the floor of the narrow rows' checks
# (``grads_close``).
WIDE_D, WIDE_F, WIDE_C = 1024, 4096, 10
WIDE_GMM_FWD = {"wide pool": (BATCH, N_QUERY + 1),
                "wide train targets": (200, 102)}
WIDE_GMM_BWD = {"wide train targets": (200, 102)}
ODD_GMM = dict(B=3, T=37, D=96, F=200)
WIDE_CHUNK_B = 4
WIDE_TOL = 1e-4
WIDE_REPS = dict(reps=3, iters=2)   # a pool forward takes ~0.1-0.3 s


def wide_close(got, ref):
    """(max abs error, within WIDE_TOL of ref's largest element)."""
    err = (got - ref).abs().max().item()
    return err, err <= WIDE_TOL * ref.abs().max().item()


def chunked(fn, z, *rest):
    """``fn(z, *rest)`` over WIDE_CHUNK_B batch rows of z at a time."""
    parts = [fn(z[i:i + WIDE_CHUNK_B], *rest)
             for i in range(0, z.shape[0], WIDE_CHUNK_B)]
    if isinstance(parts[0], tuple):
        # the backward: dz by rows, the weight gradients summed
        return (torch.cat([p[0] for p in parts]),
                *(sum(p[i] for p in parts) for i in range(1, len(parts[0]))))
    return torch.cat(parts)


def two_einsum(z, w1, b1, w2, b2):
    """The library yardstick: the head as two einsums."""
    return torch.einsum("btcf,cfo->btco", torch.relu(
        torch.einsum("btd,cdf->btcf", z, w1) + b1), w2) + b2


def phase_wide_gmm():
    """Phase wide (a), GMM: both kernels at al1d_wide128's shapes and at
    the odd width against their plain versions (and autograd of the two
    einsums), WIDE_TOL of the largest element; the backward bitwise
    repeatable, on dyadic inputs (``gmm_inputs(grid=True)``: exact
    pre-activations, so both sides take the same relu mask); times."""
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the plain versions would not be "
                             "float32")
    names = ("dz", "dw1", "db1", "dw2", "db2")
    rows, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    cases = [("fwd", what, B, T, WIDE_D, WIDE_F)
             for what, (B, T) in WIDE_GMM_FWD.items()]
    cases += [("bwd", what, B, T, WIDE_D, WIDE_F)
              for what, (B, T) in WIDE_GMM_BWD.items()]
    odd = ODD_GMM
    cases += [(part, "odd D=96 F=200", odd["B"], odd["T"], odd["D"], odd["F"])
              for part in ("fwd", "bwd")]
    for seed, (part, what, B, T, D, Fw) in enumerate(cases):
        z, w1, b1, w2, b2 = gmm_inputs(B, T, 80 + seed, D=D, F=Fw,
                                       C=WIDE_C, grid=part == "bwd")
        C = WIDE_C
        n = B * T
        if part == "fwd":
            got = ghk.gmm_head_fwd(z, w1, b1, w2, b2)
            torch.cuda.synchronize()
            ref = chunked(ghk.gmm_head_fwd_plain, z, w1, b1, w2, b2)
            err, ok = wide_close(got, ref)
            if not ok:
                raise AssertionError(
                    f"gmm_head_fwd disagrees with its plain version at "
                    f"{what} B={B} T={T} D={D} F={Fw}: max abs {err:.3e} "
                    f"(largest {ref.abs().max():.3e})")
            errs = {"out": err}
            largest = {"out": ref.abs().max().item()}
            del got, ref
            args = (z, w1, b1, w2, b2)
            row = dict(
                B=B, T=T, D=D, F=Fw, errors=errs,
                ms=time_ms(lambda: ghk.gmm_head_fwd(*args), **WIDE_REPS),
                device_ms=device_ms(lambda: ghk.gmm_head_fwd(*args),
                                    **WIDE_REPS),
                plain_ms=time_ms(lambda: chunked(ghk.gmm_head_fwd_plain,
                                                 *args), **WIDE_REPS),
                library_ms=time_ms(lambda: chunked(two_einsum, *args),
                                   **WIDE_REPS),
                **gmm_fwd_bound(B, T, D, Fw, C))
        else:
            g = torch.randn(B, T, C, 3, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(90 + seed))
            got = ghk.gmm_head_bwd(z, w1, b1, w2, g)
            again = ghk.gmm_head_bwd(z, w1, b1, w2, g)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"gmm_head_bwd is not deterministic at "
                                     f"{what}")
            del again
            plain = ghk.gmm_head_bwd_plain(z, w1, b1, w2, g)
            leaves = [t.clone().requires_grad_() for t in (z, w1, b1, w2, b2)]
            lib = torch.autograd.grad(two_einsum(*leaves), leaves, g)
            errs = {}
            largest = {n: p.abs().max().item() for n, p in zip(names, plain)}
            for name, a, p, r in zip(names, got, plain, lib):
                for ref_name, ref in (("plain", p), ("autograd", r)):
                    err, ok = wide_close(a, ref)
                    if not ok:
                        raise AssertionError(
                            f"gmm_head_bwd {name} disagrees with {ref_name} "
                            f"at {what} B={B} T={T} D={D} F={Fw}: max abs "
                            f"{err:.3e} (largest {ref.abs().max():.3e})")
                    errs[f"{name} vs {ref_name}"] = err
            del got, plain, lib
            out = two_einsum(*leaves)
            nbytes = 4 * (2 * n * D + n * 3 * C + 2 * (w1.numel() + b1.numel()
                                                       + w2.numel()) + 3 * C)
            row = dict(
                B=B, T=T, D=D, F=Fw, errors=errs,
                ms=time_ms(lambda: ghk.gmm_head_bwd(z, w1, b1, w2, g),
                           **WIDE_REPS),
                device_ms=device_ms(lambda: ghk.gmm_head_bwd(z, w1, b1, w2,
                                                             g),
                                    **WIDE_REPS),
                plain_ms=time_ms(lambda: ghk.gmm_head_bwd_plain(
                    z, w1, b1, w2, g), **WIDE_REPS),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), **WIDE_REPS),
                **gmm_bound(n * C * 6 * D * Fw, n * C * 12 * Fw, nbytes))
            del out, leaves
        worst[part] = max([worst[part]] + list(errs.values()))
        row.update(largest=largest, shape=[B, T, D, Fw, C])
        rows[f"{part} {what}"] = row
        log("wide", f"gmm_head_{part} {what} B={B} T={T} D={D} F={Fw} "
            f"C={C}: max abs err "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + " (largest elements "
            + ", ".join(f"{k} {e:.3e}" for k, e in largest.items()) + ")"
            + f"; kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}),"
            f" plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; FMA bound {row['fma_bound_ms']:.4f} ms)")
        del z, w1, b1, w2, b2
        torch.cuda.empty_cache()
    return rows, worst


def phase_wide_kernels():
    """Phase wide (a): every kernel at al1d_wide128's shapes and at the
    odd widths against its plain version; times.  {record}, {worst}."""
    rec = {}
    rec["gmm"], gmm_err = phase_wide_gmm()
    rec["flash"], flash_err = phase_flash_kernels(WIDE_FLASH_CASES)
    rec["flash_bf16"], bf16_err = phase_flash_kernels_bf16(WIDE_FLASH_CASES)
    errs = {"gmm_head_fwd": gmm_err["fwd"], "gmm_head_bwd": gmm_err["bwd"],
            "flash_attn_fwd": flash_err["fwd"],
            "flash_attn_bwd": flash_err["bwd"],
            "flash_attn_fwd_bf16": bf16_err["fwd"],
            "flash_attn_bwd_bf16": bf16_err["bwd"]}
    return rec, errs


def reset_launches():
    from aline_tpu_torch.ops import _build
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def launches():
    """Every kernel's launches since the last reset."""
    from aline_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)


def flash_inputs(B, H, n_points, n_target, dh, with_time, blind, n_ctx,
                 seed):
    """q, k, v, dO and the role codes of a GP-AL-like batch on the card:
    every target selected, and about 16 context points (``n_ctx`` None)
    or ``n_ctx`` of them scattered over the points.  ``blind``: the last
    batch row has no context and no selected target, so its rows see no
    key (or only the time column)."""
    from aline_tpu_torch.ops.roles import build_roles, roles_to_codes
    g = torch.Generator(device="cuda").manual_seed(seed)
    if n_ctx is None:
        ctx = torch.rand(B, n_points, generator=g,
                         device="cuda") < 16 / n_points
        ctx[:, 0] = True
    else:
        pick = torch.rand(B, n_points, generator=g,
                          device="cuda").argsort(dim=1)[:, :n_ctx]
        ctx = torch.zeros(B, n_points, dtype=torch.bool, device="cuda")
        ctx.scatter_(1, pick, True)
    tmask = torch.ones(n_target, dtype=torch.bool, device="cuda")
    if blind:
        ctx[-1] = False
        tmask[:] = False
    kcode, qrow = roles_to_codes(build_roles(ctx, n_target, tmask,
                                             with_time))
    N = kcode.shape[1]
    q, k, v, do = (torch.randn(B, H, N, dh, generator=g, device="cuda")
                   for _ in range(4))
    return q, k, v, kcode, qrow, do


# label: B, H, n_points, n_target, dh, time token, blind rows, context
# points (None: about 16)
FLASH_CASES = {
    "eval": (BATCH, 4, N_QUERY + 1, 102, 8, False, False, None),
    "train": (200, 4, 201, 102, 8, False, False, None),
    "burning": (200, 4, 31, 102, 8, False, False, None),
    "ragged": (3, 2, 30, 6, 8, True, True, None),
    "dh64": (4, 8, 2000, 47, 64, True, False, None),
    # step 30 of the eval: 31 context points scattered over the pool
    "eval_late": (BATCH, 4, N_QUERY + 1, 102, 8, False, False, T_STEPS + 1),
    # phase 19's data-parallel steps: each of 2 ranks holds 100 rows
    "dp_train": (100, 4, 201, 102, 8, False, False, None),
    "dp_burning": (100, 4, 31, 102, 8, False, False, None),
    # phase 21b's BED traces of loc_100k under flash (B=200, T=34): the
    # unsharded sequence [1 + 2000 pool points | 2 targets] and a rank's
    # of 3, [35 context copies + 667 pool points | 2 targets], at step 17
    # (18 context points)
    "bed": (200, 4, 2001, 2, 8, False, False, 18),
    "bed_seq_rank": (200, 4, 702, 2, 8, False, False, 18),
    # phase wide's al1d_wide128 (8 heads of 128): its eval pool (forward
    # only) and its training sequence, and an odd width through the
    # padding (dh=24 runs as 32)
    "wide_eval": (BATCH, 8, N_QUERY + 1, 102, 128, False, False, None),
    "wide_train": (200, 8, 201, 102, 128, False, False, None),
    "odd_dh24": (4, 2, 200, 47, 24, True, False, None),
}
WIDE_FLASH_CASES = ("wide_eval", "wide_train", "odd_dh24")
NARROW_FLASH_CASES = tuple(c for c in FLASH_CASES
                           if c not in WIDE_FLASH_CASES)
# forward only: the traces and the wide eval run no backward
FWD_ONLY = ("bed", "bed_seq_rank", "wide_eval")
CHECK_ROWS = 8            # batch rows compared at the eval shapes
WITNESS_ROWS = 25         # phase 4b's compact rollout on the CPU
# larger [B, H, N, N] plain and SDPA backwards are not timed, but at the
# eval shapes (7.1 GB of scores: the few such tensors each holds fit the
# card's 80 GB)
PLAIN_BWD_MAX_BYTES = 2**30
PLAIN_BWD_EVAL = ("eval", "eval_late")


def score_pairs(kcode, qrow):
    """The (row, key) pairs whose score the role-masked attention needs,
    summed over the batch rows: each row's allowed keys, and all N keys
    for a row that sees none (its output and gradients are averages over
    every column).  Per head."""
    n_ctx = (kcode == 1).sum(dim=1, keepdim=True)
    n_extra = (kcode == 2).sum(dim=1, keepdim=True)
    per_row = n_ctx + (qrow == 1) * n_extra                  # [B, N]
    return int(torch.where(per_row == 0, kcode.shape[1], per_row).sum())


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def phase_flash_plan(kcode, qrow, what):
    """The plan kernel against its plain version, bitwise; its times."""
    from aline_tpu_torch.ops import flash_attention as fa
    plan = fa.flash_plan(kcode, qrow)
    torch.cuda.synchronize()
    ref = fa.flash_plan_plain(kcode, qrow)
    for name, a, r in zip(fa.FlashPlan._fields, plan, ref):
        if not torch.equal(a, r):
            raise AssertionError(f"flash_plan {name} differs from its plain "
                                 f"version at {what}")
    B, N = kcode.shape
    # reads kcode and qrow, writes both permutations and four counts
    rec = dict(shape=[B, N], max_abs_err=0.0, dense_rows=int(plan.dense.sum()),
               ms=time_ms(lambda: fa.flash_plan(kcode, qrow)),
               device_ms=device_ms(lambda: fa.flash_plan(kcode, qrow)),
               plain_ms=time_ms(lambda: fa.flash_plan_plain(kcode, qrow)),
               library_ms=None,
               **bound(0, 4 * (4 * B * N + 4 * B)))
    log("kernels", f"flash_plan {what} B={B} N={N}: bitwise equal to the "
        f"plain plan ({rec['dense_rows']} dense batch rows); kernel "
        f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms (bytes)")
    return plan, rec


def check_flash_bwd(what, blind, q, k, v, kcode, qrow, o, lse, do):
    """3c's backward check: two calls bitwise equal, each gradient held to
    the plain backward (and, where every row sees a key, to autograd of
    the plain forward) within ``grads_close``; {name: max abs error}."""
    from aline_tpu_torch.ops import flash_attention as fa
    grads = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    again = fa.flash_attn_bwd(q, k, v, kcode, qrow, o, lse, do)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"flash_attn_bwd is not deterministic at "
                             f"{what}")
    refs = {"plain": fa.flash_attn_bwd_plain(q, k, v, kcode, qrow, o, lse,
                                             do)}
    if not blind:
        # autograd of the replaced scores gives a row that sees no key
        # no gradient; the kernels follow the TPU kernel there
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attn_fwd_plain(*leaves, kcode, qrow)[0]
        refs["autograd"] = torch.autograd.grad(out, leaves, do)
    errs = {}
    for ref_name, ref in refs.items():
        for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
            err, ok = grads_close(a, r)
            if not ok:
                raise AssertionError(
                    f"flash_attn_bwd {name} disagrees with {ref_name} "
                    f"at {what}: max abs {err:.3e}")
            errs[f"{name} vs {ref_name}"] = err
    return errs


def phase_flash_kernels(cases=NARROW_FLASH_CASES):
    from aline_tpu_torch.ops import flash_attention as fa
    rows, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for what in cases:
        case = FLASH_CASES[what]
        q, k, v, kcode, qrow, do = flash_inputs(
            *case, seed=30 + list(FLASH_CASES).index(what))
        B, H, N, dh = q.shape
        blind = case[6]
        plan, plan_rec = phase_flash_plan(kcode, qrow, what)
        # the check: the first CHECK_ROWS batch rows at the eval shapes
        n = CHECK_ROWS if what in PLAIN_BWD_EVAL + FWD_ONLY else B
        cq, ck, cv, cdo = (t[:n].contiguous() for t in (q, k, v, do))
        ckc, cqr = kcode[:n].contiguous(), qrow[:n].contiguous()
        o, lse = fa.flash_attn_fwd(cq, ck, cv, ckc, cqr)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attn_fwd_plain(cq, ck, cv, ckc, cqr)
        errs = {}
        for name, got, ref in (("O", o, ref_o), ("lse", lse, ref_lse)):
            abs_err, rel_err, ok = close(got, ref)
            if not ok:
                raise AssertionError(
                    f"flash_attn_fwd {name} disagrees with its plain version "
                    f"at {what} {tuple(q.shape)}: max abs {abs_err:.3e}")
            errs[name] = abs_err
        if what not in FWD_ONLY:
            errs.update(check_flash_bwd(what, blind, cq, ck, cv, ckc, cqr, o,
                                        lse, cdo))
        del ref_o, ref_lse
        worst["fwd"] = max(worst["fwd"], errs["O"], errs["lse"])
        worst["bwd"] = max([worst["bwd"]] + [e for name, e in errs.items()
                                             if name.startswith("d")])

        # timings at full B, the kernels with the plan built above
        kc = kcode[:, None, None, :]
        allowed = (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))
        o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)
        small = (4 * B * H * N * N <= PLAIN_BWD_MAX_BYTES
                 or what in PLAIN_BWD_EVAL)
        rec = dict(shape=[B, H, N, dh], n_checked=n, errors=errs,
                   plan=plan_rec)
        fwd_only = what in FWD_ONLY
        fwd_bytes = 4 * (4 * B * H * N * dh + B * H * N + 2 * B * N)
        bwd_bytes = 4 * (8 * B * H * N * dh + B * H * N + 2 * B * N)
        # the FLOPs this batch's mask needs (4·dh a pair forward, 10·dh
        # backward), and beside them every pair, as the TPU kernel scores
        pairs = H * score_pairs(kcode, qrow)
        dense = B * H * N * N
        rec["fwd"] = dict(
            shape=[B, H, N, dh],
            ms=time_ms(lambda: fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)),
            device_ms=device_ms(lambda: fa.flash_attn_fwd(q, k, v, kcode,
                                                          qrow, plan)),
            plain_ms=time_ms(lambda: fa.flash_attn_fwd_plain(
                q, k, v, kcode, qrow), reps=3, iters=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed)),
            dense_bound_ms=bound(4 * dense * dh, fwd_bytes)["bound_ms"],
            pairs=pairs, dense_pairs=dense,
            **bound(4 * pairs * dh, fwd_bytes))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa = (F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
                if small and not fwd_only else None)
        if not fwd_only:
            rec["bwd"] = dict(
                shape=[B, H, N, dh],
                ms=time_ms(lambda: fa.flash_attn_bwd(q, k, v, kcode, qrow, o,
                                                     lse, do, plan)),
                device_ms=device_ms(lambda: fa.flash_attn_bwd(
                    q, k, v, kcode, qrow, o, lse, do, plan)),
                plain_ms=(time_ms(lambda: fa.flash_attn_bwd_plain(
                    q, k, v, kcode, qrow, o, lse, do), reps=3, iters=3)
                    if small else None),
                library_ms=(time_ms(lambda: torch.autograd.grad(
                    sdpa, leaves, do, retain_graph=True)) if small else None),
                dense_bound_ms=bound(10 * dense * dh, bwd_bytes)["bound_ms"],
                pairs=pairs, dense_pairs=dense,
                **bound(10 * pairs * dh, bwd_bytes))
        rows[what] = rec
        for part in ("fwd",) if fwd_only else ("fwd", "bwd"):
            r = rec[part]
            plain, lib = ("not timed" if r[key] is None
                          else f"{r[key]:.4f} ms"
                          for key in ("plain_ms", "library_ms"))
            log("kernels", f"flash_attn_{part} {what} B={B} H={H} N={N} "
                f"dh={dh}: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}), plain {plain}, SDPA {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{pairs / dense:.1%} of the pairs; all pairs "
                f"{r['dense_bound_ms']:.4f} ms)")
        log("kernels", f"flash {what}: {n} of {B} batch rows checked, "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + ("" if fwd_only else "; backward bitwise repeatable"))
        del q, k, v, do, o, lse, allowed, plan, leaves, sdpa
        torch.cuda.empty_cache()
    if cases == NARROW_FLASH_CASES:
        rows["no_sync"] = phase_flash_no_sync()
    return rows, worst


def phase_flash_no_sync():
    """The plan, a flash forward and its backward through the autograd
    entry at the training shape, with any host synchronisation an
    error."""
    from aline_tpu_torch.ops import flash_attention as fa
    q, k, v, kcode, qrow, do = flash_inputs(*FLASH_CASES["train"], seed=29)
    torch.cuda.synchronize()
    reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = fa.flash_plan(kcode, qrow)
        fa.flash_role_attention(*leaves, kcode, qrow, plan).backward(do)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {n: c for n, c in launches().items()
              if n.startswith("flash") and c}
    if counts != {"flash_plan": 1, "flash_attn_fwd": 1, "flash_attn_bwd": 1}:
        raise AssertionError(f"no-sync run launched {counts}")
    log("kernels", f"flash plan, forward and backward at "
        f"{tuple(q.shape)} under set_sync_debug_mode('error'): no host "
        f"synchronisation, launches {counts}")
    return counts


def run_slice(tag, cfg, model, batch, gen):
    """The three-strategy rollout with its launch counts and checks."""
    from aline_tpu_torch.eval.al_curves import compare_strategies

    reset_launches()
    t0 = time.perf_counter()
    curves = compare_strategies(model, batch, T_STEPS, gen,
                                time_token=cfg.time_token)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    forwards = (T_STEPS + 1) * len(curves)
    head = model.head.target_head
    # the GMM kernel per forward: the pool's and the targets' token sets,
    # where the head's rule sends them (bfloat16: the pool only)
    per_forward = (int(head.use_kernel(batch.n_points))
                   + int(head.use_kernel(batch.n_target)))
    want = expected_launches(
        cfg, gmm_head_fwd=per_forward * forwards,
        flash_plan=forwards, flash_attn_fwd=cfg.encoder.num_layers
        * forwards)
    if counts != want:
        raise AssertionError(f"kernel launches in the {tag} slice {counts}, "
                             f"expected {want}")
    n_ctx0 = int(batch.ctx_mask[0].sum())
    result = {}
    for name, out in curves.items():
        lp, rm, idx = out["log_prob"], out["rmse"], out["idx"]
        if not (torch.isfinite(lp).all() and torch.isfinite(rm).all()):
            raise AssertionError(f"{name}: non-finite curves")
        if lp.shape != (BATCH, T_STEPS + 1) or idx.shape != (BATCH, T_STEPS):
            raise AssertionError(f"{name}: curve shapes {tuple(lp.shape)}, "
                                 f"{tuple(idx.shape)}")
        # the pool is every point past the initial context; a point stays
        # in it until chosen, so "in the pool when chosen" = in range and
        # distinct within the row
        if not ((idx >= n_ctx0) & (idx < batch.n_points)).all():
            raise AssertionError(f"{name}: an index outside the pool")
        srt = idx.sort(dim=1).values
        if (srt[:, 1:] == srt[:, :-1]).any():
            raise AssertionError(f"{name}: a point was chosen twice")
        ll0, llT = lp[:, 0].mean().item(), lp[:, -1].mean().item()
        result[name] = dict(ll_step0=ll0, ll_final=llT,
                            rmse_final=rm[:, -1].mean().item())
        log(tag, f"{name}: mean log_prob step 0 {ll0:.4f}, step "
            f"{T_STEPS} {llT:.4f}; final rmse "
            f"{result[name]['rmse_final']:.4f}")
    if not result["aline"]["ll_final"] > result["aline"]["ll_step0"]:
        raise AssertionError(f"{tag}: aline's mean log-prob did not improve")
    log(tag, f"B={BATCH} n_query={N_QUERY} T={T_STEPS}: three rollouts "
        f"{wall_s:.3f} s, launches {counts}")
    return dict(strategies=result, rollouts_s=wall_s, launches=counts), \
        curves


def run_copy(name, dtype=None, attention_impl=None, fused_gmm=None,
             src=RUN_DIR, under=OUT_DIR):
    """A copy of the flagship's run directory, or of ``src`` (its
    config.json only, with the given changes) under ``under``, for
    ``load_model`` and the entry points, which write under it."""
    run_dir = Path(under) / name
    run_dir.mkdir(parents=True, exist_ok=True)
    run_cfg = json.loads((src / "config.json").read_text())
    if dtype is not None:
        run_cfg["dtype"] = dtype
    if attention_impl is not None:
        run_cfg["encoder"]["attention_impl"] = attention_impl
    if fused_gmm is not None:
        run_cfg["head"]["fused_gmm"] = fused_gmm
    (run_dir / "config.json").write_text(json.dumps(run_cfg, indent=2))
    return str(run_dir)


def f32_run():
    """The flagship's run directory pinned to float32 (phases 4-7b)."""
    return run_copy("f32_run", dtype="float32")


def batch_rows(batch, rows, device):
    """The first ``rows`` batch rows of ``batch`` on ``device``."""
    per_row = ("x", "y", "ctx_mask", "target_x", "target_all", "theta",
               "ctx_idx")
    return batch.to(device).replace(**{
        f: getattr(batch, f)[:rows].to(device) for f in per_row
        if getattr(batch, f) is not None})


def expected_launches(cfg, *, gmm_head_fwd=0, gmm_head_bwd=0, flash_plan=0,
                      flash_attn_fwd=0, flash_attn_bwd=0, loc_eig_fold=0,
                      ces_eig_fold=0):
    """Every counter's expected launches on a path of ``cfg``: the flash
    counts go to the run's dtype's entries, and to none without flash."""
    from aline_tpu_torch.models.aline import compute_dtype
    want = {name: 0 for name in launches()}
    want.update(gmm_head_fwd=gmm_head_fwd, gmm_head_bwd=gmm_head_bwd,
                loc_eig_fold=loc_eig_fold, ces_eig_fold=ces_eig_fold)
    if cfg.encoder.attention_impl == "flash":
        sfx = "" if compute_dtype(cfg) == torch.float32 else "_bf16"
        want.update({"flash_plan": flash_plan,
                     f"flash_attn_fwd{sfx}": flash_attn_fwd,
                     f"flash_attn_bwd{sfx}": flash_attn_bwd})
    return want


def phase_slice():
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model = load_model(f32_run(), AL1D_200K_PARAMS, "cuda")
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    batch = task.sample_batch(gen, BATCH, n_query=N_QUERY)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    log("slice", f"GP batch B={BATCH} n_query={N_QUERY}: {sample_s:.3f} s")
    rec, curves = run_slice("slice", cfg, model, batch, gen)
    rec["sample_s"] = sample_s
    return rec, batch, curves


def first_change(got, ref):
    """[B] rows whose choices differ at some step, and the first such
    step (0 where none)."""
    diff = got != ref
    return diff.any(dim=1), diff.int().argmax(dim=1)


def phase_flash_slice(batch, compact):
    """The flagship with attention_impl=flash, through a copy of its run
    config, on phase 4's batch, against the compact path on the card:
    every forward along the compact path's aline trajectory (design
    probabilities, posterior means) within ``FWD_TOL``; the rows whose
    greedy choices agree throughout within 1e-4; and every row that chose
    differently doing so at a tie of the compact path's own log-probs
    (within ``TIE``).  The witness: the compact path itself on the CPU,
    on the first WITNESS_ROWS rows, whose rows that leave the card's
    trajectory must do so at ties too.  Both final mean log-prob
    differences are reported: a row that leaves a tie the other way
    follows another trajectory."""
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model = load_model(run_copy("flash_run", dtype="float32",
                                     attention_impl="flash"),
                            AL1D_200K_PARAMS, "cuda")
    if cfg.encoder.attention_impl != "flash":
        raise AssertionError("the run config did not select flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, curves = run_slice("flash slice", cfg, model, batch, gen)

    _, model_c = load_model(f32_run(), AL1D_200K_PARAMS, "cuda")
    _, model_cpu = load_model(f32_run(), AL1D_200K_PARAMS, "cpu")
    t0 = time.perf_counter()
    witness = al_rollout_curves(model_cpu,
                                batch_rows(batch, WITNESS_ROWS, "cpu"),
                                T_STEPS, strategy="aline")
    witness_s = time.perf_counter() - t0
    ref = compact["aline"]
    runs = {"flash": {k: v.cpu() for k, v in curves["aline"].items()},
            "compact CPU": witness}
    ref_idx = ref["idx"].cpu()
    for run in runs.values():
        n = run["idx"].shape[0]
        run["differs"], run["first"] = first_change(run["idx"], ref_idx[:n])
        run["gap"] = torch.zeros(n)

    b = init_ctx_idx(batch, min(int(batch.ctx_mask[0].sum()) + T_STEPS,
                                batch.n_points))
    rows = torch.arange(BATCH)
    err = {"flash vs compact": 0.0, "compact CPU vs card": 0.0}
    with torch.no_grad():
        for t in range(T_STEPS + 1):
            out_f, out_c = model(b), model_c(b)
            out_h = model_cpu(batch_rows(b, CHECK_ROWS, "cpu"))
            for key, a, r in (
                    ("flash vs compact", out_f, out_c),
                    ("compact CPU vs card", out_h, out_c)):
                n = a.design_out.zt.shape[0]
                for x, y in ((a.design_out.zt, r.design_out.zt),
                             (a.posterior_out.mixture_means,
                              r.posterior_out.mixture_means)):
                    err[key] = max(err[key], (x.cpu() - y[:n].cpu()).abs()
                                   .max().item())
            if t == T_STEPS:
                break
            # where a row first chose differently: the compact path's
            # log-prob (card) of its own choice minus that of the other
            lp = out_c.design_out.zt.clamp_min(1e-30).log().cpu()
            for run in runs.values():
                n = run["idx"].shape[0]
                here = run["differs"] & (run["first"] == t)
                gap = (lp[rows[:n], ref_idx[:n, t]]
                       - lp[rows[:n], run["idx"][:, t]])
                run["gap"] = torch.where(here, gap, run["gap"])
            b, _, _ = select_design(b, ref["idx"][:, t])
    log("flash slice", f"along the compact path's aline trajectory, design "
        f"probs and posterior means: flash vs compact (card, {BATCH} rows) "
        f"within {err['flash vs compact']:.3e}; compact on the CPU vs on "
        f"the card ({CHECK_ROWS} rows) within "
        f"{err['compact CPU vs card']:.3e}")
    summary = {}
    for name, run in runs.items():
        same = ~run["differs"]
        n = same.numel()
        ref_lp = ref["log_prob"][:n].cpu()
        summary[name] = dict(
            rows=n, rows_differing=int(run["differs"].sum()),
            max_tie_gap=run["gap"].max().item(),
            same_rows_curve_max_abs=(
                (run["log_prob"] - ref_lp).abs()[same].max()
                .item() if same.any() else 0.0),
            final_mean_log_prob_diff=abs(
                run["log_prob"][:, -1].mean().item()
                - ref_lp[:, -1].mean().item()))
        r = summary[name]
        log("flash slice", f"{name} against compact on the card, same "
            f"batch: {r['rows_differing']} of {n} rows chose "
            f"differently at some step, largest log-prob gap where they did "
            f"{r['max_tie_gap']:.3e}; the other rows' curves within "
            f"{r['same_rows_curve_max_abs']:.3e}; final mean log-prob "
            f"differs by {r['final_mean_log_prob_diff']:.3e}")
    log("flash slice", f"compact CPU rollout of the witness: {witness_s:.1f} s")
    bad = [f"{name}: {key} {r[key]:.3e} above {lim:.0e}"
           for name, r in summary.items()
           for key, lim in (("max_tie_gap", TIE),
                            ("same_rows_curve_max_abs", TOL))
           if r[key] > lim]
    if err["flash vs compact"] > FWD_TOL:
        bad.append(f"forwards differ by {err['flash vs compact']:.3e}, "
                   f"above {FWD_TOL:.0e}")
    if bad:
        raise AssertionError("flash slice: " + "; ".join(bad))
    rec.update(against_compact=summary, forward_max_abs=err,
               witness_s=witness_s)
    return rec


def phase_parity():
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model_cpu = load_model(f32_run(), AL1D_200K_PARAMS, "cpu")
    _, model_gpu = load_model(f32_run(), AL1D_200K_PARAMS, "cuda")
    batch = build_task(cfg.task).sample_batch(
        torch.Generator().manual_seed(1), 4, n_query=64)
    worst = 0.0
    # "random" draws from a device generator, so CPU and card differ
    for strategy in ("aline", "uncertainty"):
        cpu = al_rollout_curves(model_cpu, batch, 5, strategy=strategy)
        gpu = al_rollout_curves(model_gpu, batch.to("cuda"), 5,
                                strategy=strategy)
        if not torch.equal(cpu["idx"], gpu["idx"].cpu()):
            raise AssertionError(f"{strategy}: CPU and card chose different "
                                 f"points")
        for key in ("log_prob", "rmse"):
            abs_err, _, ok = close(gpu[key].cpu(), cpu[key])
            if not ok:
                raise AssertionError(f"{strategy} {key}: CPU and card differ "
                                     f"by {abs_err:.3e}")
            worst = max(worst, abs_err)
    log("parity", f"CPU vs card, B=4 n_query=64 T=5: same indices, curves "
        f"within {worst:.3e}")
    return worst


def phase_train(smi, tag="train", extra=()):
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.train.loop import Trainer

    out_dir = OUT_DIR / f"{tag.replace(' ', '_')}_smoke"
    cfg = parse_overrides(TRAIN_ARGS + list(extra)
                          + [f"output_dir={out_dir}"])
    trainer = Trainer(cfg, device="cuda")
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    trainer._ensure_phase("burning")
    burning_opt = trainer.optimizer
    per_epoch, totals = [], {name: 0 for name in launches()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for epoch in range(cfg.max_epoch):
        reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_epoch(epoch)
        m = {k: float(v) for k, v in m.items()}           # sync
        seconds = time.perf_counter() - t0
        counts = launches()
        T = int(m["T"])
        fwd = T * (2 if cfg.rollout_remat else 1)
        layers = cfg.encoder.num_layers
        # the training loss reads the targets' posterior alone
        gmm = int(trainer.model.head.target_head.use_kernel(
            trainer.task.n_target_data + trainer.task.n_target_theta))
        want = expected_launches(
            cfg, gmm_head_fwd=gmm * fwd, gmm_head_bwd=gmm * T,
            flash_plan=fwd, flash_attn_fwd=layers * fwd,
            flash_attn_bwd=layers * T)
        if counts != want:
            raise AssertionError(f"{tag} epoch {epoch}: launches {counts}, "
                                 f"expected {want} (T={T}, rollout_remat="
                                 f"{cfg.rollout_remat})")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"epoch {epoch}: non-finite metrics {m}")
        for name in totals:
            totals[name] += counts[name]
        per_epoch.append(dict(epoch=epoch, phase=trainer.phase, s=seconds,
                              **m))
        log(tag, f"epoch {epoch} ({trainer.phase}): {seconds * 1e3:.1f} "
            f"ms, loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, "
            f"launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    snapshot = out_dir / "model" / "aline_burning.npz"
    if not snapshot.exists():
        raise AssertionError("no burning snapshot at the phase switch")
    if trainer.optimizer is burning_opt or \
            len(trainer.optimizer.param_groups) != 2:
        raise AssertionError("the phase switch did not rebuild the optimizer "
                             "with the two main-phase groups")
    unchanged = [n for n, p in trainer.model.named_parameters()
                 if torch.equal(p.detach(), before[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    # warm: the main-phase epochs after the first one (which rebuilt the
    # optimizer and wrote the snapshot)
    warm = [e["s"] for e in per_epoch if e["phase"] == "main"][1:]
    warm_ms = 1e3 * statistics.median(warm)
    rollouts_s = cfg.batch_size / (warm_ms / 1e3)
    log(tag, f"B={cfg.batch_size} n_query={cfg.task.n_query_init} "
        f"T={cfg.T} dtype={cfg.dtype} attention_impl="
        f"{cfg.encoder.attention_impl}: warm "
        f"epoch {warm_ms:.1f} ms, {rollouts_s:.1f} "
        f"rollouts/s, peak memory {peak / 2**30:.3f} GiB ({smi})")
    return dict(epochs=per_epoch, warm_ms=warm_ms, rollouts_s=rollouts_s,
                peak_bytes=peak, launches=totals)


def _dense_f64(self, x):
    """``Dense.forward`` in bf16 with the product summed in float64, then
    rounded to bf16 once as before: the same function, another order."""
    cd = self.compute_dtype
    if cd == torch.float32:
        return torch.nn.Linear.forward(self, x)
    y = torch.matmul(x.to(cd).double(), self.weight.to(cd).double().t())
    return y.to(cd) + self.bias.to(cd)


def train_step_parity(label, cfg, model_cpu, *, time_token=False,
                      unresolved=None, reward_from_cpu=False,
                      witness=False):
    """One optimizer step of ``model_cpu`` on the CPU (plain versions)
    and of a copy on the card (kernels), from the same B=4, n_query=16,
    T=5 batch with the data mask and the same Gumbel noise.  In float32
    the losses are held to 1e-4 and the gradients element by element (see
    below); in bfloat16 (``model_cpu`` computing in it) the losses to
    ``BF16_LOSS_RTOL`` of the loss's scale and each parameter's gradient to
    a relative L2 error of ``BF16_GRAD_RTOL``, without the entries that
    shift every logit of a softmax alike (``shift_invariant``).  Returns
    the worst error and the card step's launches.  ``unresolved`` (f32):
    called after the steps, {parameter name: bool mask} of gradient
    entries whose reference is ill-determined, left out of the
    elementwise check and reported.  ``reward_from_cpu``: the card's
    REINFORCE reward is the CPU pass's (``cpu_reward``, as phases 16 and
    17 hold theirs), and what its own would move is reported."""
    from aline_tpu_torch.models.aline import compute_dtype
    from aline_tpu_torch.models.dense import Dense
    from aline_tpu_torch.train import loop
    bf16 = compute_dtype(cfg) == torch.bfloat16
    from aline_tpu_torch.models.heads import gumbel_noise
    from aline_tpu_torch.ops.target_mask import target_weight_vectors
    from aline_tpu_torch.tasks import build_task, init_ctx_idx
    from aline_tpu_torch.train.loop import train_step
    from aline_tpu_torch.train.optimizer import build_optimizer
    from aline_tpu_torch.train.rollout import rollout

    T = 5
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    task = build_task(cfg.task)
    gen = torch.Generator().manual_seed(2)
    batch = task.sample_batch(gen, 4, n_query=16)
    mask = torch.arange(batch.n_target) < batch.n_target_data   # data
    batch = init_ctx_idx(batch.replace(target_mask=mask),
                         task.n_context_init + T)
    w_q, w_p = (torch.from_numpy(w) for w in target_weight_vectors(
        mask.numpy(), "mix", "split", task.n_target_data,
        task.n_target_theta))
    noise = gumbel_noise((T, batch.batch_size, batch.n_points), gen)
    sel = (tuple(range(task.n_target_data))
           if cfg.encoder.attention_impl in ("auto", "compact") else None)
    runs, idx, seen = {}, {}, {}
    undo = patched([(loop, "total_loss", cpu_reward(seen, by_order=True))]
                   if reward_from_cpu else [])
    passes = [("cpu", model_cpu, "cpu"), ("gpu", model_gpu, "cuda")]
    if witness:
        passes.append(("witness", copy.deepcopy(model_cpu), "cpu"))
    for name, model, dev in passes:
        dense_undo = patched([(Dense, "forward", _dense_f64)]
                             if name == "witness" else [])
        reset_launches()
        with torch.no_grad():
            idx[name] = rollout(model, batch.to(dev), T, w_q.to(dev),
                                w_p.to(dev), noise.to(dev),
                                time_token=time_token,
                                sel_targets=sel).idx.cpu()
        opt, sched = build_optimizer(cfg, model, "main")
        m = train_step(model, opt, sched, batch.to(dev), T, w_q.to(dev),
                       w_p.to(dev), cfg.alpha, noise.to(dev),
                       gamma=cfg.gamma, sel_targets=sel,
                       time_token=time_token)
        runs[name] = (m, {n: p.detach().cpu() for n, p in
                          model.named_parameters()},
                      {n: p.grad.cpu() for n, p in model.named_parameters()})
        patched(dense_undo)
        if name == "gpu":
            counts, card_seen = launches(), dict(seen)
    patched(undo)
    if reward_from_cpu:
        log(label, f"the card's REINFORCE reward is the CPU pass's: its own "
            f"would set {card_seen['flips']} gains' clamps otherwise and "
            f"move the design loss by {card_seen['design_loss_move']:.3e} "
            f"(nll_query within {card_seen['nll_query_max_abs_err']:.3e})")
    (m_c, p_c, g_c), (m_g, p_g, g_g) = runs["cpu"], runs["gpu"]
    if not torch.equal(idx["cpu"], idx["gpu"]):
        raise AssertionError(f"{label}: CPU and card drew different designs "
                             f"from the same noise")
    if bf16:
        return bf16_step_parity(label, cfg, model_cpu, m_c, m_g, g_c, g_g,
                                witness=runs.get("witness")), counts
    worst = 0.0
    for k in ("loss", "design_loss", "predict_loss"):
        abs_err, _, ok = close(m_g[k].cpu(), m_c[k])
        if not ok:
            raise AssertionError(f"{label} {k}: CPU {m_c[k]:.6f}, card "
                                 f"{m_g[k]:.6f}")
        worst = max(worst, abs_err)
    # gradients: within 1e-4 of each element plus 1e-4 of the model's
    # largest gradient element (sums over the batch, rollout and layers in
    # another order on each device)
    scale = max(g.abs().max() for g in g_c.values())
    unresolved = unresolved() if unresolved else {}
    for n, g in g_c.items():
        err = (g_g[n] - g).abs()
        within = err <= TOL * g.abs() + TOL * scale
        if n in unresolved:
            skip = unresolved[n]
            past = int((~within & skip).sum())
            log(label, f"grad of {n}: {int(skip.sum())} of {skip.numel()} "
                f"entries ill-determined (left out), {past} of them past "
                f"the limit, largest difference "
                f"{err[skip].max() if skip.any() else 0.0:.3e}; the rest "
                f"within {err[~skip].max():.3e}")
            within |= skip
        if not bool(within.all()):
            raise AssertionError(f"{label}: grad of {n} differs between "
                                 f"CPU and card by {err[~within].max():.3e}")
    # updated params: Adam's first step divides each gradient element by
    # its own size, so an element whose CPU-card difference is not small
    # against it (1%) moves by an ill-determined amount up to lr either
    # way (entries that shift every logit of a softmax alike, such as the
    # score head's output bias, have only rounding noise for a gradient).
    # Resolved elements within 1e-4; the rest within 2·lr of each other.
    resolved_n = total_n = 0
    for n in p_c:
        resolved = g_c[n].abs() >= 100 * (g_g[n] - g_c[n]).abs()
        err = (p_g[n] - p_c[n]).abs()
        ok = bool((err[resolved] <= TOL + TOL * p_c[n].abs()[resolved])
                  .all()) and bool((err <= 2 * cfg.lr + TOL).all())
        if not ok:
            raise AssertionError(f"{label}: {n} differs between CPU and "
                                 f"card by {err.max():.3e}")
        if resolved.any():
            worst = max(worst, err[resolved].max().item())
        resolved_n += int(resolved.sum())
        total_n += resolved.numel()
    log(label, f"one step, B=4 n_query=16 T={T}, attention_impl="
        f"{cfg.encoder.attention_impl}, time token {time_token}: loss CPU "
        f"{float(m_c['loss']):.6f}, card {float(m_g['loss']):.6f}, same "
        f"designs; grads within tolerance; updated params within "
        f"{worst:.3e} on the {resolved_n} of {total_n} entries whose "
        f"gradient the two devices resolve")
    return worst, counts


def phase_train_parity():
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)
    cfg, model = load_model(f32_run(), AL1D_200K_PARAMS, "cpu")
    return train_step_parity("train parity", cfg, model)[0]


def phase_flash_train_parity():
    """A fresh model from the seed with the time token, the time feature
    and the flash attention."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.models.aline import build_model
    cfg = parse_overrides(TRAIN_ARGS + TIME_FLASH_ARGS)
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(cfg.seed)
        model = build_model(cfg, "cpu")
    return train_step_parity("flash time parity", cfg, model,
                             time_token=True)[0]


# -- bfloat16 (phases 3d, 4c, 4d, 6c, 7c) -------------------------------------

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7     # bfloat16's spacing relative to a value, at most
# Phase 3d: a bf16 flash kernel against its plain version in bf16 on the
# same inputs.  Both compute in float32 and round each output once, so O
# and dQ are within one ulp of each element plus a float32 floor of the
# largest one; dK and dV also by the plain version's per-block roundings
# (as the TPU kernel sums them into bf16 per block of block_q rows): up to
# 2^-8 of a partial sum per block.
# Every FLASH_CASES shape, forward and backward (the plain backward checked
# on CHECK_ROWS batch rows at the eval shapes, as in 3c).
BF16_FLASH_CASES = ("eval", "train", "burning", "dp_train", "dp_burning",
                    "eval_late", "ragged", "dh64", "bed", "bed_seq_rank")
# Phases 4c and 4d, the card against the port on the CPU in bf16 (one
# code): the float32 sums inside each bf16 layer run in other orders on the
# two devices, which now and then moves a bf16 rounding, and the compact
# path's bf16 attention scores (ulp 2^-4 at |s| >= 16) carry such a move
# on through the layers.  Along the CPU's trajectory, at least
# BF16_CARD_SHARE of the design-score and posterior-mean elements lie
# within one bf16 ulp of the CPU's (elements under 2^-6 of the tensor's
# largest counted at that floor's ulp), none beyond BF16_CARD_ULPS; a row
# may leave the CPU's trajectory only where the CPU's bf16 design scores
# of the two candidates lie within BF16_TIE_ULPS (0: an exact tie).  The
# readings behind each limit (NVIDIA H100 80GB HBM3) are in PERF.md,
# section 6: BF16_CARD_ULPS is at least 1.4 times the largest distance
# read, BF16_TIE_ULPS the largest tie gap read.  Phase 4c's control, the
# card in float32 held to the CPU in bf16, must fail the share: else the
# share could not tell apart a card path that skips bf16.
BF16_CARD_SHARE = 0.9
BF16_CARD_ULPS = 2048
BF16_TIE_ULPS = 2
BF16_WITNESS_ROWS = 8        # 4c: the compact path on the CPU
# 4d: the flash plain versions on the CPU (3 rows until PR 15, cut to fit
# phase wide in the time limit)
BF16_FLASH_WITNESS_ROWS = 2
# Phase 7c: one bf16 step on the card against one on the CPU.  Where the
# float32 sums inside the bf16 layers run in other orders, a bf16 rounding
# moves, and the move reaches every gradient through the backward pass.
# On an NVIDIA H100 80GB HBM3 the worst parameter read 0.25% (compact),
# 0.32% (fused_gmm=on) and 2.6% (flash with the time token).
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 4e-2
# a step held against a witness of its reference summed in another order
# (phase wide's bf16 step): twice the witness's largest gradient distance
WITNESS_FACTOR = 2


def bf16_close(got, ref, floor, extra=0.0):
    """(max abs error, within tolerance) for a bf16 output: one bf16 ulp
    of each element plus ``floor`` of ref's largest element (plus
    ``extra``, elementwise, where given)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool((err <= BF16_ULP * ref.abs() + floor * ref.abs().max()
               + extra).all())
    return err.max().item(), ok


def delta_rounding(q, k, kcode, qrow, o, lse, do):
    """(dQ, dK) bounds [B, H, N, dh] of what one bf16 ulp of each row's
    D = bf16(sum_d dO·O) moves the bf16 backward by.  The kernel and the
    plain version sum D's dh products in other orders, and a float32 sum
    within rounding of a bf16 boundary rounds to either neighbour; then
    dS_ij = P_ij (dP_ij - D_i) moves by P_ij ulp(D_i), dQ_i by
    scale · ulp(D_i) · sum_j P_ij |k_j| and dK_j by scale · sum_i P_ij
    ulp(D_i) |q_i|.  At dh=8 D is small and this is below the floors; at
    dh=128 D sums 128 products and its ulp moves dQ by up to 2 ulps."""
    from aline_tpu_torch.ops import flash_attention as fa
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(fa._masked_scores(q, k, kcode, qrow) - lse[..., None])
    d = torch.sum(do.float() * o.float(), dim=-1).to(BF16).float()
    ulp = 2.0 ** (torch.floor(torch.log2(d.abs().clamp_min(2.0 ** -126)))
                  - 7)
    dq = scale * ulp[..., None] * torch.einsum("bhqk,bhkd->bhqd", p,
                                                k.float().abs())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", p,
                              ulp[..., None] * q.float().abs())
    return dq, dk


def phase_flash_kernels_bf16(cases=BF16_FLASH_CASES):
    """3d: the bf16 flash kernels at every shape of ``cases``
    (``BF16_FLASH_CASES``) against their plain versions in bf16 on the
    card; times."""
    from aline_tpu_torch.ops import flash_attention as fa
    rows, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for what in cases:
        seed = (BF16_FLASH_CASES.index(what) if what in BF16_FLASH_CASES
                else len(BF16_FLASH_CASES) + WIDE_FLASH_CASES.index(what))
        q, k, v, kcode, qrow, do = (
            t.to(BF16) if t.is_floating_point() else t
            for t in flash_inputs(*FLASH_CASES[what], seed=60 + seed))
        B, H, N, dh = q.shape
        plan = fa.flash_plan(kcode, qrow)
        n = CHECK_ROWS if what in PLAIN_BWD_EVAL + FWD_ONLY else B
        cq, ck, cv, cdo = (t[:n].contiguous() for t in (q, k, v, do))
        ckc, cqr = kcode[:n].contiguous(), qrow[:n].contiguous()
        o, lse = fa.flash_attn_fwd(cq, ck, cv, ckc, cqr)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attn_fwd_plain(cq, ck, cv, ckc, cqr)
        errs = {}
        err, ok = bf16_close(o, ref_o, 1e-5)
        lse_err, _, lse_ok = close(lse, ref_lse)
        if not (ok and lse_ok and o.dtype == BF16):
            raise AssertionError(f"bf16 flash_attn_fwd disagrees with its "
                                 f"plain version at {what}: O {err:.3e}, "
                                 f"lse {lse_err:.3e}")
        errs.update(O=err, lse=lse_err)
        if what not in FWD_ONLY:
            grads = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
            again = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"bf16 flash_attn_bwd is not "
                                     f"deterministic at {what}")
            ref = fa.flash_attn_bwd_plain(cq, ck, cv, ckc, cqr, o, lse, cdo)
            blocks = -(-N // fa.block_q(N))
            floors = (TOL, *(2 * [(blocks + 1) * 2.0 ** -8]))
            # the wide cases' heads: D's rounding (delta_rounding)
            extras = ((*delta_rounding(cq, ck, ckc, cqr, o, lse, cdo), 0.0)
                      if what in WIDE_FLASH_CASES else (0.0, 0.0, 0.0))
            for name, a, r, floor, extra in zip(("dq", "dk", "dv"), grads,
                                                ref, floors, extras):
                err, ok = bf16_close(a, r, floor, extra)
                if not (ok and a.dtype == BF16):
                    raise AssertionError(
                        f"bf16 flash_attn_bwd {name} disagrees with its "
                        f"plain version at {what}: max abs {err:.3e} "
                        f"(largest {r.float().abs().max():.3e})")
                errs[name] = err
            # the kernel's own sums: over all rows in float32, rounded once
            once = fa.flash_attn_bwd_plain(cq, ck, cv, ckc, cqr, o, lse, cdo,
                                           per_block=False)
            for name, a, r, extra in zip(("dk", "dv"), grads[1:], once[1:],
                                         extras[1:]):
                err, ok = bf16_close(a, r, TOL, extra)
                if not ok:
                    raise AssertionError(
                        f"bf16 flash_attn_bwd {name} disagrees with the plain "
                        f"version summed once at {what}: max abs {err:.3e}")
                errs[f"{name} vs summed once"] = err
            del grads, again, ref, once, extras
        del ref_o, ref_lse
        worst["fwd"] = max(worst["fwd"], errs["O"], errs["lse"])
        worst["bwd"] = max([worst["bwd"]] + [e for name, e in errs.items()
                                             if name.startswith("d")])

        kc = kcode[:, None, None, :]
        allowed = (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))
        o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)
        pairs = H * score_pairs(kcode, qrow)
        # 2 bytes an element of q, k, v, O (dO, dQ, dK, dV); 4 of lse (and
        # the backward's D) and of the codes
        fwd_bytes = 2 * 4 * B * H * N * dh + 4 * B * H * N + 4 * 2 * B * N
        bwd_bytes = (2 * 8 * B * H * N * dh + 4 * 2 * B * H * N
                     + 4 * 2 * B * N)
        rec = dict(shape=[B, H, N, dh], dtype="bfloat16", n_checked=n,
                   errors=errs)
        rec["fwd"] = dict(
            shape=[B, H, N, dh],
            ms=time_ms(lambda: fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)),
            device_ms=device_ms(lambda: fa.flash_attn_fwd(q, k, v, kcode,
                                                          qrow, plan)),
            plain_ms=time_ms(lambda: fa.flash_attn_fwd_plain(
                q, k, v, kcode, qrow), reps=3, iters=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed)),
            pairs=pairs, **bf16_flash_bound(2 * pairs * dh, 2 * pairs * dh,
                                            fwd_bytes))
        rows[what] = rec
        if what in FWD_ONLY:
            parts = ("fwd",)
        else:
            parts = ("fwd", "bwd")
            # the plain and SDPA backwards timed where 3c times them
            small = (4 * B * H * N * N <= PLAIN_BWD_MAX_BYTES
                     or what in PLAIN_BWD_EVAL)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            sdpa = (F.scaled_dot_product_attention(*leaves,
                                                   attn_mask=allowed)
                    if small else None)
            rec["bwd"] = dict(
                shape=[B, H, N, dh],
                ms=time_ms(lambda: fa.flash_attn_bwd(q, k, v, kcode, qrow, o,
                                                     lse, do, plan)),
                device_ms=device_ms(lambda: fa.flash_attn_bwd(
                    q, k, v, kcode, qrow, o, lse, do, plan)),
                plain_ms=(time_ms(lambda: fa.flash_attn_bwd_plain(
                    q, k, v, kcode, qrow, o, lse, do), reps=3, iters=3)
                    if small else None),
                library_ms=(time_ms(lambda: torch.autograd.grad(
                    sdpa, leaves, do, retain_graph=True)) if small else None),
                pairs=pairs, **bf16_flash_bound(4 * pairs * dh,
                                                6 * pairs * dh, bwd_bytes))
            del leaves, sdpa
        for part in parts:
            r = rec[part]
            plain, lib = ("not timed" if r[key] is None
                          else f"{r[key]:.4f} ms"
                          for key in ("plain_ms", "library_ms"))
            log("kernels", f"bf16 flash_attn_{part} {what} B={B} H={H} "
                f"N={N} dh={dh}: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}), plain {plain}, SDPA bf16 {lib}, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; P- and "
                f"dS-products on FMAs {r['fma_bound_ms']:.4f} ms)")
        log("kernels", f"bf16 flash {what}: {n} of {B} batch rows checked, "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        del q, k, v, do, o, lse, allowed, plan
        torch.cuda.empty_cache()
    return rows, worst


# the kernels by summed device time that device_busy names
BUSY_TOP_KERNELS = 10


def device_busy(fn):
    """(device busy ms, wall ms, {kernel: ms}) of ``fn`` under
    ``torch.profiler``: the union of the kernels' intervals, the host
    clock around the run (slowed by the profiler), and the
    ``BUSY_TOP_KERNELS`` kernels by their summed device time."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import busy_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)
    ranked = sorted(by_name.items(),
                    key=lambda kv: -kv[1])[:BUSY_TOP_KERNELS]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    return busy / 1e3, wall * 1e3, dict(ranked)


def design_forward(model, b):
    """(model output, the raw design scores [B, n_points]) of one eval
    forward: the scores are the acquisition head's output, bf16 values
    widened to float32 in a bf16 model."""
    seen = []
    hook = model.head.acquisition_head.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        out = model(b)
    finally:
        hook.remove()
    return out, seen[0]


def bf16_ulps(got, ref):
    """The distance of ``got`` from ``ref`` in bf16 ulps of each ref
    element, elements under 2^-6 of ref's largest counted at that floor."""
    got, ref = got.float().cpu(), ref.float().cpu()
    mag = ref.abs().clamp_min(2.0 ** -6 * ref.abs().max())
    return (got - ref).abs() / (BF16_ULP * mag)


def score_gap_ulps(scores, a, b):
    """[rows] distance in bf16 ulps between scores[r, a[r]] and
    scores[r, b[r]] (bf16 values), through the bf16 bit patterns."""
    bits = scores.to(BF16).view(torch.int16).to(torch.int32)
    key = torch.where(bits < 0, -(bits & 0x7FFF), bits)
    rows = torch.arange(scores.shape[0])
    return (key[rows, a] - key[rows, b]).abs()


def hold_trajectory(tag, batch, ref_idx, ref_model, others, rows,
                    max_ulps=None, T=T_STEPS, negligible_p=None):
    """Along the reference's aline trajectory ``ref_idx`` [rows, T] over
    the first ``rows`` rows of ``batch``: every model of ``others``
    ({name: (model, its own idx [rows, T])}) is run on the reference's
    state at every step, its design scores and posterior means held to
    ``max_ulps`` of the reference's; and every row whose own choices leave
    the reference's must do so where the reference's bf16 design scores
    of the two candidates lie within BF16_TIE_ULPS.  With ``max_ulps``
    None both are only read.  With ``negligible_p``, a design score whose
    candidate has a probability below it on both devices (the pool's
    softmax) is left out of ``max_ulps`` and read apart
    (``negligible_max_ulps``); it still counts in the share within one
    ulp.  Returns the readings per model."""
    from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
    b = init_ctx_idx(batch, min(int(batch.ctx_mask[0].sum()) + T,
                                batch.n_points))
    ref_dev = next(ref_model.parameters()).device
    b = batch_rows(b, rows, ref_dev)
    ref_idx = ref_idx.cpu()
    res = {}
    for name, (_, idx) in others.items():
        differs, first = first_change(idx.cpu(), ref_idx)
        res[name] = dict(differs=differs, first=first, ulps=0.0, near=0,
                         n=0, gap=torch.zeros(rows, dtype=torch.int32),
                         negl_ulps=0.0, negl_over=0)
    with torch.no_grad():
        for t in range(T + 1):
            out_r, s_r = design_forward(ref_model, b)
            for name, (model, idx) in others.items():
                dev = next(model.parameters()).device
                out, s = design_forward(model, b.to(dev))
                r = res[name]
                u_s = bf16_ulps(s, s_r)
                u_m = bf16_ulps(out.posterior_out.mixture_means,
                                out_r.posterior_out.mixture_means)
                for u in (u_s, u_m):
                    r["near"] += int((u <= 1).sum())
                    r["n"] += u.numel()
                if negligible_p is not None:
                    pool = b.query_mask.cpu()
                    negl = None
                    for sc in (s_r, s):
                        p = torch.softmax(torch.where(
                            pool, sc.float().cpu(),
                            torch.tensor(-math.inf)), dim=-1)
                        small = p < negligible_p
                        negl = small if negl is None else negl & small
                    if negl.any():
                        r["negl_ulps"] = max(r["negl_ulps"],
                                             u_s[negl].max().item())
                        if max_ulps is not None:
                            r["negl_over"] += int((u_s[negl]
                                                   > max_ulps).sum())
                    u_s = u_s.masked_fill(negl, 0.0)
                for u in (u_s, u_m):
                    r["ulps"] = max(r["ulps"], u.max().item())
                if t < T:
                    here = r["differs"] & (r["first"] == t)
                    gap = score_gap_ulps(s_r.cpu(), ref_idx[:, t],
                                         idx.cpu()[:, t])
                    r["gap"] = torch.where(here, gap, r["gap"])
            if t == T:
                break
            b, _, _ = select_design(b, ref_idx[:, t].to(ref_dev))
    share = BF16_CARD_SHARE if max_ulps else None
    summary, bad = {}, []
    for name, r in res.items():
        d = r["differs"]
        summary[name] = dict(
            rows=rows, forward_max_ulps=r["ulps"],
            forward_share_within_1ulp=r["near"] / r["n"],
            rows_differing=int(d.sum()),
            exact_ties=int((d & (r["gap"] == 0)).sum()),
            max_tie_gap_ulps=int(r["gap"][d].max()) if d.any() else 0)
        sm = summary[name]
        if negligible_p is not None:
            sm.update(negligible_max_ulps=r["negl_ulps"],
                      negligible_over_limit=r["negl_over"])
            log(tag, f"{name}: design scores of candidates below "
                f"probability {negligible_p:g} on both devices: within "
                f"{r['negl_ulps']:.1f} ulps, {r['negl_over']} elements past "
                f"{max_ulps} (read apart, not held to it)")
        log(tag, f"{name} along the reference's aline trajectory ({rows} "
            f"rows): forwards within {sm['forward_max_ulps']:.1f} bf16 ulps "
            f"(limit {max_ulps}), {sm['forward_share_within_1ulp']:.4%} of "
            f"the elements within 1 (limit {share}); "
            f"{sm['rows_differing']} rows leave the "
            f"trajectory, {sm['exact_ties']} of them at exact bf16 ties, "
            f"largest score gap where they do {sm['max_tie_gap_ulps']} ulps "
            f"(limit {BF16_TIE_ULPS if max_ulps else None})")
        if max_ulps is None:
            continue
        if (sm["forward_max_ulps"] > max_ulps
                or sm["forward_share_within_1ulp"] < BF16_CARD_SHARE):
            bad.append(f"{name}: forwards {sm['forward_max_ulps']:.1f} "
                       f"ulps, {sm['forward_share_within_1ulp']:.4%} within 1")
        if sm["max_tie_gap_ulps"] > BF16_TIE_ULPS:
            bad.append(f"{name}: a row leaves at a score gap of "
                       f"{sm['max_tie_gap_ulps']} ulps")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    return summary


def phase_slice_bf16(batch, curves_f32):
    """4c: the flagship eval at its own dtype, bf16, compact (``auto``),
    at the full eval size; its device busy time; held against the port on
    the CPU in bf16 over the first BF16_WITNESS_ROWS rows.  The control:
    the card in float32 (phase 4's path and its ``curves_f32``) read the
    same way must fall below BF16_CARD_SHARE."""
    from aline_tpu_torch.eval.al_curves import (
        al_rollout_curves, compare_strategies)
    from aline_tpu_torch.models.aline import compute_dtype
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cuda")
    if compute_dtype(cfg) != BF16:
        raise AssertionError(f"the flagship loads in {compute_dtype(cfg)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, curves = run_slice("bf16 slice", cfg, model, batch, gen)
    busy, wall, _ = device_busy(lambda: compare_strategies(
        model, batch, T_STEPS, gen, time_token=cfg.time_token))
    rec.update(busy_ms=busy, profiled_wall_ms=wall)
    log("bf16 slice", f"under the profiler: device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall ({100 * busy / wall:.1f}%)")
    _, model_cpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    rows = BF16_WITNESS_ROWS
    t0 = time.perf_counter()
    witness = al_rollout_curves(model_cpu, batch_rows(batch, rows, "cpu"),
                                T_STEPS, strategy="aline")
    rec["witness_s"] = time.perf_counter() - t0
    rec["against_cpu"] = hold_trajectory(
        "bf16 slice", batch, witness["idx"], model_cpu,
        {"card": (model, curves["aline"]["idx"][:rows])}, rows,
        BF16_CARD_ULPS)
    _, model_f32 = load_model(f32_run(), AL1D_200K_PARAMS, "cuda")
    control = hold_trajectory(
        "bf16 slice", batch, witness["idx"], model_cpu,
        {"float32 card (control)": (model_f32,
                                    curves_f32["aline"]["idx"][:rows])},
        rows)
    rec["control_f32"] = control
    log("bf16 slice", f"CPU witness rollout ({rows} rows): "
        f"{rec['witness_s']:.1f} s")
    share = control["float32 card (control)"]["forward_share_within_1ulp"]
    if share >= BF16_CARD_SHARE:
        raise AssertionError(f"bf16 slice: the float32 card keeps {share:.4%}"
                             f" of the elements within one ulp of the CPU's "
                             f"bf16, so BF16_CARD_SHARE cannot tell it apart")
    return rec, curves, model


def mean_curve_gap(a, b):
    """Mean |difference| of two strategies' log-prob curves, all rows and
    steps, and the difference of their final means, per strategy."""
    return {name: dict(
        mean_abs=(a[name]["log_prob"] - b[name]["log_prob"]).abs().mean()
        .item(),
        final_mean_diff=(a[name]["log_prob"][:, -1].mean()
                         - b[name]["log_prob"][:, -1].mean()).item())
        for name in a}


def phase_flash_slice_bf16(batch, compact, model_c, compact_f32):
    """4d: the same eval with attention_impl=flash in bf16.  Held against
    the port's flash path on the CPU in bf16 (the same function: the
    kernels against the plain versions along the path) on the first
    BF16_FLASH_WITNESS_ROWS rows, as 4c holds compact; and against 4c's
    compact path on the card, which rounds the attention scores to bf16
    where flash keeps float32:
    the mean |log-prob difference| of the two bf16 paths, over all rows,
    steps and strategies, may not exceed the one between the compact path
    in bf16 and in float32 (phase 4) on the same batch."""
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)
    run_dir = run_copy("flash_bf16_run", attention_impl="flash")
    cfg, model = load_model(run_dir, AL1D_200K_PARAMS, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, curves = run_slice("bf16 flash slice", cfg, model, batch, gen)
    _, model_cpu = load_model(run_dir, AL1D_200K_PARAMS, "cpu")
    rows = BF16_FLASH_WITNESS_ROWS
    t0 = time.perf_counter()
    witness = al_rollout_curves(model_cpu, batch_rows(batch, rows, "cpu"),
                                T_STEPS, strategy="aline")
    rec["witness_s"] = time.perf_counter() - t0
    rec["against_cpu"] = hold_trajectory(
        "bf16 flash slice", batch, witness["idx"], model_cpu,
        {"card": (model, curves["aline"]["idx"][:rows])}, rows,
        BF16_CARD_ULPS)
    rec["against_compact"] = hold_trajectory(
        "bf16 flash slice", batch, compact["aline"]["idx"], model_c,
        {"flash vs compact": (model, curves["aline"]["idx"])}, BATCH)
    gaps = {"flash vs compact, bf16": mean_curve_gap(curves, compact),
            "compact bf16 vs f32": mean_curve_gap(compact, compact_f32)}
    rec["curve_gaps"] = gaps
    for what, g in gaps.items():
        log("bf16 flash slice", f"{what}: " + ", ".join(
            f"{n} mean |dlog-prob| {v['mean_abs']:.4f}, final mean "
            f"{v['final_mean_diff']:+.4f}" for n, v in g.items()))
    paths_gap, dtype_gap = (
        statistics.mean(v["mean_abs"] for v in g.values())
        for g in gaps.values())
    log("bf16 flash slice", f"CPU witness rollout ({rows} rows): "
        f"{rec['witness_s']:.1f} s; flash vs compact {paths_gap:.4f} "
        f"against bf16 vs f32 {dtype_gap:.4f}")
    if paths_gap > dtype_gap:
        raise AssertionError(f"bf16 flash slice: flash and compact differ "
                             f"by {paths_gap:.4f}, more than bf16 and f32 "
                             f"({dtype_gap:.4f})")
    return rec


def shift_invariant(model):
    """{parameter name: mask of the entries that shift every logit of a
    softmax alike} (the score head's output bias, the key third of each
    qkv bias): no loss moves them, and their gradient is rounding noise."""
    out = {}
    for name, p in model.named_parameters():
        if name.endswith("acquisition_head.predictor_fc2.bias"):
            out[name] = torch.ones(p.shape, dtype=torch.bool)
        elif name.endswith("self_attn.qkv_proj.bias"):
            d = p.numel() // 3
            out[name] = torch.arange(p.numel()) // d == 1
    return out


def bf16_step_parity(label, cfg, model, m_c, m_g, g_c, g_g,
                     what="B=4 n_query=16 T=5", sides=("CPU", "card"),
                     witness=None):
    """The bf16 checks of ``train_step_parity``: losses and per-parameter
    gradients of the ``sides[1]`` step (``m_g``, ``g_g``) against the
    ``sides[0]`` step (``m_c``, ``g_c``), one step at ``what``.  With
    ``witness`` ((metrics, params, grads) of the reference step summed in
    another order) the gradient limit is the larger of BF16_GRAD_RTOL and
    WITNESS_FACTOR times the witness's largest relative L2 distance."""
    ref_side, got_side = sides
    worst = 0.0
    # the design loss is a small difference of normalised rewards: each
    # term is held to BF16_LOSS_RTOL of the loss's scale
    scale = abs(float(m_c["predict_loss"])) + abs(float(m_c["design_loss"]))
    for k in ("loss", "design_loss", "predict_loss"):
        a, r = float(m_g[k]), float(m_c[k])
        if abs(a - r) > BF16_LOSS_RTOL * scale:
            raise AssertionError(f"{label} {k}: {ref_side} {r:.6f}, "
                                 f"{got_side} {a:.6f}")
    invariant = shift_invariant(model)

    def rel_l2(n, other):
        keep = ~invariant.get(n, torch.zeros(g_c[n].shape, dtype=torch.bool))
        ref = g_c[n][keep]
        return ((other[n][keep] - ref).norm()
                / ref.norm().clamp_min(1e-30)).item()
    limit = BF16_GRAD_RTOL
    if witness is not None:
        spread = max(rel_l2(n, witness[2]) for n in g_c)
        limit = max(limit, WITNESS_FACTOR * spread)
        log(label, f"witness (the {ref_side} step with its Dense products "
            f"summed in float64): gradients within {spread:.3e} of the "
            f"{ref_side}'s (relative L2), losses "
            + ", ".join(f"{k} {float(witness[0][k]):.6f}"
                        for k in ("loss", "design_loss", "predict_loss"))
            + f"; gradient limit {limit:.3e}")
    worst_name = None
    for n, g in g_c.items():
        rel = rel_l2(n, g_g)
        if rel > limit:
            raise AssertionError(f"{label}: grad of {n} differs between "
                                 f"{ref_side} and {got_side} by {rel:.3e} "
                                 f"(relative L2)")
        if rel > worst:
            worst, worst_name = rel, n
    log(label, f"one bf16 step, {what}, attention_impl="
        f"{cfg.encoder.attention_impl}, fused_gmm={cfg.head.fused_gmm}: "
        f"loss {ref_side} {float(m_c['loss']):.6f}, {got_side} "
        f"{float(m_g['loss']):.6f}; per-parameter gradients within "
        f"{worst:.3e} (relative L2, {worst_name}; limit {limit:.3e})")
    return worst


def phase_train_parity_bf16():
    """7c: one bf16 step on the card against one on the CPU: the flagship
    (compact), a fresh flash model with the time token, and the flagship
    with fused_gmm=on (both GMM kernels on the bf16 path)."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.models.aline import build_model
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)
    out = {}
    cfg, model = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    out["compact"] = train_step_parity("bf16 parity", cfg, model)
    cfg = parse_overrides(TRAIN_ARGS + TIME_FLASH_ARGS + ["dtype=bfloat16"])
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(cfg.seed)
        model = build_model(cfg, "cpu")
    out["flash time"] = train_step_parity("bf16 flash time parity", cfg,
                                          model, time_token=True)
    cfg, model = load_model(run_copy("fused_gmm_run", fused_gmm="on"),
                            AL1D_200K_PARAMS, "cpu")
    out["fused_gmm=on"] = train_step_parity("bf16 fused_gmm parity", cfg,
                                            model)
    for label, (_, counts) in out.items():
        log("bf16 parity", f"{label}: card step launches "
            f"{ {n: c for n, c in counts.items() if c} }")
    sfx = {"compact": (), "flash time": ("flash_attn_fwd_bf16",
                                         "flash_attn_bwd_bf16"),
           "fused_gmm=on": ("gmm_head_fwd", "gmm_head_bwd")}
    for label, names in sfx.items():
        missing = [n for n in names if not out[label][1][n]]
        if missing:
            raise AssertionError(f"bf16 {label} step launched no {missing}")
    return {label: dict(max_rel=w, launches=c)
            for label, (w, c) in out.items()}


# Phases 8, 8b and 9: location finding and its sPCE/sNMC bounds on
# checkpoints/loc_100k (weights from the committed npz), in the run's own
# dtype, bfloat16; the bounds in float32.
LOC_RUN = ROOT / "checkpoints" / "loc_100k"
# scripts/eval_bed.py's full protocol (its defaults; T = eval.T_final -
# n_context_init = 34, so 35 steps of bounds)
BED = dict(L=1_000_000, M=2000, batch_size=200, n_query=2000, T=34, seed=0)
# The JAX package's per-step bounds at the same protocol, computed on a TPU
# (bound values, not times): the policy's, and random designs'.  The
# port's final sPCE must lie within BED_SIGMAS combined standard errors
# of each.
ARTIFACTS = ROOT / "benchmarks" / "artifacts"
JAX_BED = {"aline": (ARTIFACTS / "loc_r4_100k_N2000_T35_L1e6.npz", ""),
           "random": (ARTIFACTS / "loc_r3_random_N2000_T35_L1e6.npz",
                      "random_")}
BED_SIGMAS = 4
# nmc - pce >= log(L / (L + 1)) for the same draws; the float32 rounding
# of two bounds near 10 moves it by a few 1e-6
BED_NMC_SLACK = 1e-5
BED_WITNESS_ROWS = 8
BED_WITNESS_L = 20_000
# Phase 9: the loc recipe of loc_100k's config.json (B=200, T=30,
# n_query_init=200, bf16, its eval group), fresh init, 2 burning and 3
# main epochs; the in-training bounds run once (epoch 0) at the config's
# eval.L=50000, M=2000, batch_size=1000, and the final per-step bounds at
# eval.*_final with M_final cut to one batch of 200
LOC_TRAIN_ARGS = ["task=location_finding", "batch_size=200", "min_T=30",
                  "T=30", "dtype=bfloat16", "rollout_remat=true",
                  "eval.EIG=true", "eval.L=50000", "eval.M=2000",
                  "eval.batch_size=1000", "eval.L_final=1000000",
                  "eval.M_final=200", "eval.batch_size_final=200",
                  "eval.n_query_final=2000", "eval.T_final=35",
                  "burning_epoch=2", "max_epoch=5", "verbose=5",
                  "checkpoint=0"]
# NVIDIA H100 SXM, per SM and clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): 128 float32
# add/multiply/FMA and 16 special-function (rcp, lg2, ex2) results; 132
# SMs at the 1.98 GHz boost clock (the 67 TFLOP/s of PEAK_F32_FLOPS)
PEAK_F32_INSTR = 132 * 128 * 1.98e9
PEAK_MUFU_INSTR = 132 * 16 * 1.98e9


def eig_fold_bound(L, B, Th, K, D):
    """Bounds of the EIG fold of location finding with K sources in D
    dimensions over L draws of B rows of Th steps:

    * fused, in registers: ``portbench/counts/eig_fold.py``'s counts (per
      term 3KD + 2K + 9 FMA-pipe FLOPs and K + 2 special-function
      results, the draws, the bytes) at this script's rates; the
      special-function results bound it.
    * eager, as PyTorch runs it: 4KD + 6K + 25 float32 passes (reads plus
      writes) over the [Lc, B, Th] block per term: the [.., K, D]
      differences and squares, 12 elementwise passes, the cumulative sum
      and the fold's max, shift, exp and sum, at the HBM rate.

    Returns (fused seconds, eager seconds)."""
    from portbench.counts.eig_fold import loc_counts
    c = loc_counts(L, B, Th, K, D)
    eager = L * B * Th * 4 * (4 * K * D + 6 * K + 25) / PEAK_HBM_BYTES
    return max(c["fma_flops"] / PEAK_F32_FLOPS,
               c["sfu_ops"] / PEAK_MUFU_INSTR,
               c["bytes"] / PEAK_HBM_BYTES), eager


# Phase 3e: the EIG fold of location finding at the BED cell's shape
# (portbench's loc_100k.bed_L1e6: B=200, 34 steps after the context point,
# L=1e6 draws of K=1 source in D=2)
FOLD = dict(B=200, Th=35, L=1_000_000, K=1, D=2)


def phase_fold_kernel():
    """3e: ``loc_eig_fold`` against its plain version on the card at the
    BED cell's chunk (Lc = ``chunk_size``'s 9,586 draws, and the last
    chunk's 3,056, into a filled state): each (row, step)'s logsumexp
    within 1e-5 plus (Th + 8) float32 ulps of its size (the reason is in
    tests/test_torch_cuda.py), two calls bitwise equal; the chunk's kernel
    ms (eager, the wrapper's host work included), device ms (a CUDA graph
    of the calls) and the plain version's ms, against the chunk's share of
    the bound (``eig_fold_bound``: the special-function results); and a
    whole batch's fold (``compute_eig_from_history`` at L=1e6, stepwise,
    the draws included: host clock between synchronises, 3 seeds) against
    the batch's bound, with one launch a chunk."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.eval import eig
    from aline_tpu_torch.ops import eig_fold_kernel as efk
    from aline_tpu_torch.parallel.collectives import (
        lse_init, lse_update, lse_value)
    from aline_tpu_torch.tasks.location_finding import HiddenLocation

    B, Th, L, K, D = (FOLD[k] for k in ("B", "Th", "L", "K", "D"))
    task = HiddenLocation(parse_overrides(["task=location_finding"]).task)
    g = torch.Generator(device="cuda").manual_seed(30)
    theta0 = task.sample_theta(g, (B,))
    x = task.unnormalise_design(task.sample_data(g, B, Th))
    y = task.simulate(g, x, theta0[:, None])
    y2 = y[..., 0].contiguous()
    Lc = eig.chunk_size(L, B, Th, 32_768)
    n_chunks = math.ceil(L / Lc)
    last = L - (n_chunks - 1) * Lc
    thetas = task.sample_theta(g, (Lc, B))
    state = lse_update(lse_init((B, Th), device="cuda"), -60.0 * torch.rand(
        5, B, Th, generator=g, device="cuda"), axis=0)
    worst = 0.0
    for n in (Lc, last):
        got = task.fold_eig_chunk(state, x, y2, thetas, n)
        again = task.fold_eig_chunk(state, x, y2, thetas, n)
        torch.cuda.synchronize()
        if not (torch.equal(got.max, again.max)
                and torch.equal(got.sumexp, again.sumexp)):
            raise AssertionError(f"loc_eig_fold: two calls differ (n={n})")
        want = lse_value(efk.eig_fold_plain(state, x, y2, thetas, n,
                                            task.log_likelihood))
        err = (lse_value(got) - want).abs()
        if not (err <= 1e-5 + (Th + 8) * 2.0 ** -24 * want.abs()).all():
            raise AssertionError(f"loc_eig_fold disagrees with its plain "
                                 f"version (n={n}): max abs "
                                 f"{err.max().item():.3e}")
        worst = max(worst, err.max().item())

    def fold():
        return task.fold_eig_chunk(state, x, y2, thetas, Lc)

    bound_s = eig_fold_bound(Lc, B, Th, K, D)[0]
    row = dict(
        B=B, T=Th, shape=[Lc, B, Th, K, D], max_abs_err=worst,
        ms=time_ms(fold), device_ms=device_ms(fold),
        plain_ms=time_ms(lambda: efk.eig_fold_plain(
            state, x, y2, thetas, Lc, task.log_likelihood), reps=3, iters=3),
        library_ms=None, bound_ms=1e3 * bound_s, bound_by="operations")
    eig.compute_eig_from_history(task, theta0, x, y, L, 1, stepwise=True)
    reset_launches()
    batch_s = []
    for seed in (2, 3, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eig.compute_eig_from_history(task, theta0, x, y, L, seed,
                                     stepwise=True)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    if launches()["loc_eig_fold"] != 3 * n_chunks:
        raise AssertionError(f"fold: {launches()['loc_eig_fold']} launches "
                             f"in 3 batches of {n_chunks} chunks")
    row.update(Lc=Lc, last_chunk=last, chunks_per_batch=n_chunks,
               batch_ms=1e3 * statistics.median(batch_s),
               batch_bound_ms=1e3 * eig_fold_bound(L, B, Th, K, D)[0])
    log("fold", f"loc_eig_fold B={B} Th={Th} K={K} D={D}, a chunk of "
        f"{Lc} draws (the last of {n_chunks}: {last}): max abs err "
        f"{worst:.3e}, bitwise over two calls; kernel {row['ms']:.4f} ms "
        f"(device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms,"
        f" bound {row['bound_ms']:.4f} ms (operations); a batch's fold "
        f"(L={L:g}, draws included) {row['batch_ms']:.3f} ms (median of 3,"
        f" {n_chunks} launches each), bound {row['batch_bound_ms']:.3f} ms")
    return row, worst


# Phase 3e, CES: the EIG fold at the CES cell's shape (portbench's
# ces_200k.bed_L1e7: B=100, 15 steps after the context point, L=1e7 draws)
CES_FOLD = dict(B=100, Th=16, L=10_000_000)


def phase_ces_fold_kernel():
    """3e, CES: ``ces_eig_fold`` against its plain version on the card at
    the CES cell's chunk (Lc = ``chunk_size``'s 32,768 draws, and the last
    chunk's 5,760, into a filled state): each (row, step)'s logsumexp
    within ``ces_fold_tolerance``, two calls bitwise equal; the chunk's
    kernel, device and plain ms against the chunk's share of the bound
    (``ces_fold_bound``); and a whole batch's fold (L=1e7, stepwise, the
    draws included: host clock between synchronises, 3 seeds) against the
    batch's bound, with one launch a chunk.  Returns (row, max abs
    error)."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.eval import eig
    from aline_tpu_torch.ops import eig_fold_kernel as efk
    from aline_tpu_torch.parallel.collectives import (
        lse_init, lse_update, lse_value)
    from aline_tpu_torch.tasks.ces import CESTask

    B, Th, L = (CES_FOLD[k] for k in ("B", "Th", "L"))
    task = CESTask(parse_overrides(["task=ces"]).task)
    g = torch.Generator(device="cuda").manual_seed(31)
    theta0 = task.sample_theta(g, (B,))
    x = task.sample_data(g, B, Th)
    y = task.simulate(g, x, theta0[:, None])
    y2 = y[..., 0].contiguous()
    Lc = eig.chunk_size(L, B, Th, 32_768)
    n_chunks = math.ceil(L / Lc)
    last = L - (n_chunks - 1) * Lc
    thetas = task.sample_theta(g, (Lc, B))
    state = lse_update(lse_init((B, Th), device="cuda"), -60.0 * torch.rand(
        5, B, Th, generator=g, device="cuda"), axis=0)
    worst, share = 0.0, 0.0
    for n in (Lc, last):
        got = task.fold_eig_chunk(state, x, y2, thetas, n)
        again = task.fold_eig_chunk(state, x, y2, thetas, n)
        torch.cuda.synchronize()
        if not (torch.equal(got.max, again.max)
                and torch.equal(got.sumexp, again.sumexp)):
            raise AssertionError(f"ces_eig_fold: two calls differ (n={n})")
        want = lse_value(efk.eig_fold_plain(state, x, y2, thetas, n,
                                            task.log_likelihood)).double()
        tol = efk.ces_fold_tolerance(state, task, x, y2, thetas, n)
        a = lse_value(got).double()
        inf = torch.isinf(want)
        err = (a[~inf] - want[~inf]).abs()
        n_share = float((err / tol[~inf]).max())
        if not torch.equal(a[inf], want[inf]) or n_share > 1:
            raise AssertionError(f"ces_eig_fold disagrees with its plain "
                                 f"version (n={n}): max abs "
                                 f"{err.max().item():.3e}, {n_share:.3f} of "
                                 f"the tolerance")
        worst, share = max(worst, err.max().item()), max(share, n_share)

    def fold():
        return task.fold_eig_chunk(state, x, y2, thetas, Lc)

    row = dict(
        B=B, T=Th, shape=[Lc, B, Th, 6], max_abs_err=worst,
        max_share_of_tolerance=share, ms=time_ms(fold),
        device_ms=device_ms(fold),
        plain_ms=time_ms(lambda: efk.eig_fold_plain(
            state, x, y2, thetas, Lc, task.log_likelihood), reps=3, iters=3),
        library_ms=None, bound_ms=1e3 * ces_fold_bound(Lc * B * Th),
        bound_by="operations")
    eig.compute_eig_from_history(task, theta0, x, y, L, 1, stepwise=True)
    reset_launches()
    batch_s = []
    for seed in (2, 3, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eig.compute_eig_from_history(task, theta0, x, y, L, seed,
                                     stepwise=True)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    if launches()["ces_eig_fold"] != 3 * n_chunks:
        raise AssertionError(f"ces fold: {launches()['ces_eig_fold']} "
                             f"launches in 3 batches of {n_chunks} chunks")
    row.update(Lc=Lc, last_chunk=last, chunks_per_batch=n_chunks,
               batch_ms=1e3 * statistics.median(batch_s),
               batch_bound_ms=1e3 * ces_fold_bound(L * B * Th))
    log("fold", f"ces_eig_fold B={B} Th={Th}, a chunk of {Lc} draws (the "
        f"last of {n_chunks}: {last}): max abs err {worst:.3e}, "
        f"{share:.3f} of the tolerance, bitwise over two calls; kernel "
        f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"(operations); a batch's fold (L={L:g}, draws included) "
        f"{row['batch_ms']:.3f} ms (median of 3, {n_chunks} launches "
        f"each), bound {row['batch_bound_ms']:.3f} ms")
    return row, worst


def timed_calls(store, kind, fn):
    """``fn`` wrapped to append its host time, between two synchronises,
    to ``store`` (with the EIG calls' shapes and results)."""
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        rec = dict(kind=kind, s=time.perf_counter() - t0)
        if kind == "eig":
            x = args[2]
            rec.update(B=x.shape[0], Th=x.shape[1], L=args[4],
                       L_chunk=kw.get("L_chunk", 32_768))
            if not kw.get("L_checkpoints"):
                rec.update(pce=out[0].cpu(), nmc=out[1].cpu())
        store.append(rec)
        return out
    return wrapper


def fold_chunks(calls):
    """The chunks, one fold kernel launch each, that the EIG calls in
    ``calls`` (``timed_calls``' records, no mesh, no given thetas) fold:
    ceil(L / Lc) a call."""
    from aline_tpu_torch.eval.eig import chunk_size
    return sum(math.ceil(c["L"] / chunk_size(c["L"], c["B"], c["Th"],
                                             c["L_chunk"]))
               for c in calls if c["kind"] == "eig")


def patched(patches):
    """Set ``(module, name, value)`` attributes; returns the undo list."""
    undo = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    return undo


def bed_argv(run_dir, M):
    return [run_dir, "--L", str(BED["L"]), "--M", str(M), "--batch-size",
            str(BED["batch_size"]), "--n-query", str(BED["n_query"]),
            "--T", str(BED["T"]), "--seed", str(BED["seed"]),
            "--device", "cuda"]


def phase_bed(smi):
    """8: ``python -m aline_tpu_torch.eval_bed`` on loc_100k at the full
    protocol with the random-design baseline, through its ``main``;
    per-step bounds, the final sPCE against the JAX package's, nmc >= pce
    in every row and step, one ``loc_eig_fold`` launch a chunk and no
    other kernel, wall time split into the rollout and the EIG stage, the
    EIG stage per batch against its bounds, peak memory, and the device
    busy share of one batch."""
    from aline_tpu_torch import eval_bed
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.eval import eig

    run_dir = run_copy("bed_run", src=LOC_RUN)
    cfg = load_config(run_dir)
    calls = []
    undo = patched([
        (eig, "get_traces", timed_calls(calls, "rollout", eig.get_traces)),
        (eig, "compute_eig_from_history", timed_calls(
            calls, "eig", eig.compute_eig_from_history)),
        (eval_bed, "compute_eig_from_history", timed_calls(
            calls, "eig", eval_bed.compute_eig_from_history))])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = eval_bed.main(bed_argv(run_dir, BED["M"])
                            + ["--with-random-baseline"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    want = expected_launches(cfg, loc_eig_fold=fold_chunks(calls))
    if counts != want:
        raise AssertionError(f"bed: kernel launches {counts}, expected "
                             f"{want}")
    n_batches = -(-BED["M"] // BED["batch_size"])
    rollouts = [c for c in calls if c["kind"] == "rollout"]
    eigs = [c for c in calls if c["kind"] == "eig"]
    if len(rollouts) != n_batches or len(eigs) != 2 * n_batches:
        raise AssertionError(f"bed: {len(rollouts)} rollouts and "
                             f"{len(eigs)} EIG calls for {n_batches} batches")
    steps = BED["T"] + 1
    rec = dict(wall_s=wall, peak_bytes=peak, launches=counts)
    for who, prefix in (("aline", "aline_"), ("random", "random_")):
        m = {k: res[f"{prefix}{k}"] for k in ("pce_mean", "pce_err",
                                              "nmc_mean", "nmc_err")}
        for k, v in m.items():
            if v.shape != (steps,) or not np.isfinite(v).all():
                raise AssertionError(f"bed {who} {k}: shape {v.shape}, "
                                     f"finite {np.isfinite(v).all()}")
        path, key = JAX_BED[who]
        with np.load(path) as ref:
            want = float(ref[f"{key}pce_mean"][BED["T"]])
            want_se = float(ref[f"{key}pce_err"][BED["T"]])
        got, se = float(m["pce_mean"][-1]), float(m["pce_err"][-1])
        limit = BED_SIGMAS * math.sqrt(want_se ** 2 + se ** 2)
        for k in ("pce", "nmc"):
            log("bed", f"{who} s{k.upper()} per step (mean ± SE): " + ", ".join(
                f"{a:.3f}±{b:.3f}" for a, b in zip(m[f"{k}_mean"],
                                                    m[f"{k}_err"])))
        log("bed", f"{who}: final sPCE {got:.4f} ± {se:.4f} (SE), the JAX "
            f"package on a TPU {want:.3f} ± {want_se:.3f}: |diff| "
            f"{abs(got - want):.4f}, limit {limit:.4f} (bound values, not "
            f"times)")
        rec[who] = dict({k: v.tolist() for k, v in m.items()},
                        final_pce=got, final_se=se, jax_final_pce=want,
                        jax_final_se=want_se, limit=limit)
        if abs(got - want) > limit:
            raise AssertionError(f"bed {who}: final sPCE {got:.4f} is "
                                 f"{abs(got - want):.4f} from {want:.3f}")
    gap = min(float((c["nmc"] - c["pce"]).min()) for c in eigs)
    rec["min_nmc_minus_pce"] = gap
    log("bed", f"nmc - pce over every row and step: least {gap:.3e} "
        f"(log(L/(L+1)) = {math.log(BED['L'] / (BED['L'] + 1)):.3e}, "
        f"limit -{BED_NMC_SLACK})")
    if gap < -BED_NMC_SLACK:
        raise AssertionError(f"bed: nmc < pce - {BED_NMC_SLACK} ({gap})")
    rollout_s = sum(c["s"] for c in rollouts)
    eig_s = [c["s"] for c in eigs]
    c0 = eigs[0]
    terms = c0["L"] * c0["B"] * c0["Th"]
    bound_s, eager_s = eig_fold_bound(c0["L"], c0["B"], c0["Th"],
                                      cfg.task.K, cfg.task.dim_x)
    eig_ms = 1e3 * statistics.median(eig_s)
    rec.update(rollout_s=rollout_s, eig_s=sum(eig_s),
               eig_ms_per_batch=eig_ms, eig_ms_by_batch=[1e3 * s
                                                          for s in eig_s],
               eig_bound_ms=1e3 * bound_s, eig_bound_by="operations",
               eig_eager_bytes_ms=1e3 * eager_s, eig_terms_per_batch=terms)
    log("bed", f"M={BED['M']} B={BED['batch_size']} n_query={BED['n_query']}"
        f" T={BED['T']} L={BED['L']}: {wall:.3f} s wall; rollout "
        f"{rollout_s:.3f} s ({n_batches} batches); EIG {sum(eig_s):.3f} s "
        f"({len(eigs)} calls: policy and random); peak memory "
        f"{peak / 2**30:.3f} GiB ({smi})")
    log("bed", f"EIG stage per batch ({terms:.3e} terms): {eig_ms:.1f} ms "
        f"(median); bound {1e3 * bound_s:.2f} ms (operations, fused), the "
        f"eager passes' bytes {1e3 * eager_s:.1f} ms")
    busy_dir = run_copy("bed_busy_run", src=LOC_RUN)
    busy, pwall, top = device_busy(lambda: eval_bed.main(
        bed_argv(busy_dir, BED["batch_size"])))
    rec.update(busy_ms_one_batch=busy, profiled_wall_ms_one_batch=pwall,
               top_kernels_ms_one_batch=top)
    log("bed", f"one policy batch under the profiler: device busy "
        f"{busy:.1f} ms of {pwall:.1f} ms wall ({100 * busy / pwall:.1f}%);"
        f" kernels by device time: " + "; ".join(
            f"{name[:60]} {ms:.1f} ms" for name, ms in top.items()))
    return rec


def trace_indices(x_trace, points, n_ctx):
    """[B, T] indices among ``points`` [B, N, D] (unnormalised) of a
    trace's chosen designs ``x_trace[:, n_ctx:]``."""
    hits = (x_trace[:, n_ctx:, None, :] == points[:, None]).all(-1)
    if not (hits.sum(-1) == 1).all():
        raise AssertionError("a traced design is not one pool point")
    return hits.float().argmax(-1)


def phase_bed_witness():
    """8b: the card against the port on the CPU: greedy bf16 traces of
    BED_WITNESS_ROWS rows of a full-size batch, held as 4c holds the
    flagship (``hold_trajectory``: BF16_CARD_SHARE, BF16_CARD_ULPS, and a
    row leaves the CPU's trajectory only at a tie of at most
    BF16_TIE_ULPS); the bounds on
    pre-drawn thetas (drawn on the CPU) within 1e-4, final and stepwise;
    and one bound on the card's own draws with any host synchronisation
    an error."""
    from aline_tpu_torch.eval.eig import compute_eig_from_history
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)

    cfg, model = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cuda")
    _, model_cpu = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cpu")
    task = build_task(cfg.task)
    T, rows, n_ctx = BED["T"], BED_WITNESS_ROWS, task.n_context_init
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = task.sample_batch(gen, BED["batch_size"], n_query=BED["n_query"])
    reset_launches()
    _, x_card, _ = get_traces(model, task, batch, T)
    if any(launches().values()):
        raise AssertionError(f"bed witness: launches {launches()}")
    cpu_batch = batch_rows(batch, rows, "cpu")
    t0 = time.perf_counter()
    theta0, x, y = get_traces(model_cpu, task, cpu_batch, T)
    witness_s = time.perf_counter() - t0
    points = task.unnormalise_design(cpu_batch.x)
    summary = hold_trajectory(
        "bed witness", batch, trace_indices(x, points, n_ctx), model_cpu,
        {"card": (model, trace_indices(x_card[:rows].cpu(), points, n_ctx))},
        rows, BF16_CARD_ULPS, T=T)["card"]
    rec = dict(traces=summary, witness_s=witness_s)
    thetas = task.sample_theta(torch.Generator().manual_seed(2),
                               (BED_WITNESS_L, rows))
    dev = [t.cuda() for t in (theta0, x, y, thetas)]
    for stepwise in (False, True):
        want = compute_eig_from_history(task, theta0, x, y, 0, 0,
                                        stepwise=stepwise, thetas=thetas)
        got = compute_eig_from_history(task, *dev[:3], 0, 0,
                                       stepwise=stepwise, thetas=dev[3])
        for name, g, w in zip(("pce", "nmc"), got, want):
            err, rel, ok = close(g.cpu(), w)
            rec[f"{name}_{'stepwise' if stepwise else 'final'}"] = err
            log("bed witness", f"{name} on {BED_WITNESS_L} CPU-drawn thetas"
                f" ({rows} rows, stepwise={stepwise}): card vs CPU max abs "
                f"{err:.3e}, rel {rel:.3e} (tolerance {TOL})")
            if not ok:
                raise AssertionError(f"bed witness: {name} off by {err}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pce, nmc = compute_eig_from_history(task, *dev[:3], 100_000, 5,
                                            stepwise=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not (torch.isfinite(pce).all() and torch.isfinite(nmc).all()):
        raise AssertionError("bed witness: non-finite bounds")
    log("bed witness", f"compute_eig_from_history at L=100000 on the card's "
        f"draws under set_sync_debug_mode('error'): no host "
        f"synchronisation; CPU witness traces ({rows} rows) "
        f"{witness_s:.1f} s")
    return rec


def phase_train_loc(smi):
    """9: ``python -m aline_tpu_torch.train`` with the loc recipe and
    ``eval.EIG=true``, through its ``main``: one ``loc_eig_fold`` launch a
    chunk of the bounds and no other kernel; finite in-training bounds in
    metrics.jsonl; warm ms per epoch, the hook's wall time and peak
    memory."""
    from aline_tpu_torch.eval import eig
    from aline_tpu_torch.train import __main__ as entry
    from aline_tpu_torch.train.loop import Trainer

    out_dir = OUT_DIR / "loc_train_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)     # metrics.jsonl appends
    calls = []
    epoch_fn = Trainer.train_epoch

    def timed_epoch(self, epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = epoch_fn(self, epoch)
        torch.cuda.synchronize()
        calls.append(dict(kind="epoch", epoch=epoch, phase=self.phase,
                          s=time.perf_counter() - t0))
        return m

    undo = patched([(Trainer, "train_epoch", timed_epoch),
                    (entry, "eval_boed", timed_calls(calls, "eval_boed",
                                                     entry.eval_boed)),
                    (eig, "compute_eig_from_history", timed_calls(
                        calls, "eig", eig.compute_eig_from_history))])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = entry.main(LOC_TRAIN_ARGS + ["device=cuda",
                                               f"output_dir={out_dir}"])
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    want = expected_launches(trainer.cfg, loc_eig_fold=fold_chunks(calls))
    if counts != want:
        raise AssertionError(f"train loc: launches {counts}, expected "
                             f"{want}")
    recs = [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    bounds = [r for r in recs if "pce_mean" in r]
    if len(bounds) != 1 or not all(
            math.isfinite(bounds[0][k]) for k in ("pce_mean", "nmc_mean")):
        raise AssertionError(f"train loc: in-training bounds {bounds}")
    epochs = [c for c in calls if c["kind"] == "epoch"]
    hook_s, final_s = (c["s"] for c in calls if c["kind"] == "eval_boed")
    warm_ms = 1e3 * statistics.median(
        [e["s"] for e in epochs if e["phase"] == "main"][1:])
    log("train loc", "epochs " + ", ".join(
        f"{e['epoch']} ({e['phase']}) {1e3 * e['s']:.1f} ms" for e in epochs))
    cfg = trainer.cfg
    log("train loc", f"B={cfg.batch_size} T={cfg.T} n_query_init="
        f"{cfg.task.n_query_init} {cfg.dtype}: warm epoch {warm_ms:.1f} ms; "
        f"EIG hook (L={cfg.eval.L}, M={cfg.eval.M}, batch "
        f"{cfg.eval.batch_size}, T={cfg.T - cfg.task.n_context_init}) "
        f"{hook_s:.3f} s: sPCE {bounds[0]['pce_mean']:.4f}, sNMC "
        f"{bounds[0]['nmc_mean']:.4f}; final bounds (M={cfg.eval.M_final})"
        f" {final_s:.3f} s; peak memory {peak / 2**30:.3f} GiB ({smi})")
    return dict(epochs=epochs, warm_ms=warm_ms, hook_s=hook_s,
                final_bounds_s=final_s, bounds=bounds[0], peak_bytes=peak,
                launches=counts)


# Phases 10-13: the CES, psychometric and HPO-B tasks on their banked
# checkpoints (weights from the committed npz files, through the weights
# table of utils/serialization.py), in their own dtype, bfloat16.  No
# kernel runs on these paths but CES's EIG fold (``ces_eig_fold``, one
# launch a chunk of the bounds): the GMM kernel takes token sets of 1024
# or more in bf16 (the BED traces read the 5 theta tokens only; the
# psychometric pool has 301 tokens, HPO's 105), and ``auto`` attention is
# the compact core.
CES_RUN = ROOT / "checkpoints" / "ces_200k"
PSYCH_RUN = ROOT / "checkpoints" / "psych_100k"
# scripts/eval_bed.py's protocol for ces_200k as the JAX package ran it
# on a TPU (16 steps of bounds, so --T 15); M is cut to CES_SMOKE_M in the
# smoke run (``--ces-M 2000`` gives the full protocol)
CES_BED = dict(L=10_000_000, batch_size=100, n_query=2000, T=15, seed=0)
CES_SMOKE_M = 200
JAX_CES = {"aline": (ARTIFACTS / "ces_r4_200k_N2000_T15_L1e7.npz", "aline_"),
           "random": (ARTIFACTS / "ces_r3_random_N2000_T15_L1e7.npz",
                      "random_")}
CES_WITNESS_ROWS = 8
CES_WITNESS_L = 20_000
# card against CPU: the censored log-density as tests/test_torch_ces.py
# holds the port to JAX; the bounds on CPU-drawn thetas within this
# relative to max(|bound|, 1), plus what float32 rounding may move the
# cumulative log-likelihoods by (``ces_loglik_rounding``)
CES_BOUND_RTOL = 1e-5
CENSORED_EPS = 2.0 ** -22
# the z-scores of the censored grid's limits: body (where
# tail_mode="reference"'s log(0.5 (1 + erf)) keeps its digits), deep
# tail, beyond
CENSORED_Z = {"body": (0.0, 1.5), "deep": (5.5, 38.0), "beyond": (38.0, 200.0)}
F32_ULP = 2.0 ** -24
# scripts/eval_psychometric.py's and eval_psi.py's protocol for
# psych_100k; the JAX package's curves on a TPU (eval_psychometric.py)
# and on the CPU (eval_psi.py forces it)
PSYCH = dict(batch_size=100, n_query=300, T=30, seeds=(0, 1, 2))
PSYCH_MASKS = ("threshold_slope", "guess_lapse", "all")
JAX_PSYCH = ARTIFACTS / "psych_r4_100k_curves.npz"
JAX_PSI = ARTIFACTS / "psych_psi_curves.npz"
# eval_psi folds its subjects 4 at a time (--b-chunk's default): its peak
# memory stays under this at any B (one [4, G, N] block is 170 MB)
PSI_PEAK_LIMIT = 4 * 2**30
# the six HPO-B runs and the JAX package's test curves of each on a TPU
# (checkpoints/MANIFEST.md names the run each came from)
HPO_RUNS = {"hpo_glmnet_15k": "hpo_r3_glmnet_test_curves.npz",
            "hpo_rpart_15k": "hpo_r3_rpart_test_curves.npz",
            "hpo_xgboost_15k": "hpo_r3_xgboost_test_curves.npz",
            "hpo_ranger_15k": "hpo_r4_ranger_test_curves.npz",
            "hpo_svm_15k": "hpo_r4_svm_test_curves.npz",
            "hpo_rpart_45k": "hpo_r4_rpart45k_test_curves.npz"}
HPO = dict(T=30, n_query=100, n_target=100)
SIGMAS = 4
# Phase 13: each recipe of the banked runs' config.json (B=200, bf16),
# fresh init, 2 burning and 3 main epochs; CES with its EIG hook once
# (the config's eval.L, M, batch_size) and the final bounds cut to one
# batch at L_final=1e6
TASK_TRAIN_ARGS = {
    "ces": ["task=ces", "min_T=10", "T=10", "eval.EIG=true",
            "eval.L=50000", "eval.M=2000", "eval.batch_size=500",
            "eval.L_final=1000000", "eval.M_final=100",
            "eval.batch_size_final=100", "eval.n_query_final=2000",
            "eval.T_final=15"],
    "psychometric": [
        "task=psychometric", "task.mask_type=[predefined]",
        "task.predefined_masks=[[false,false,true,true],"
        "[true,true,false,false],[true,true,true,true]]",
        "task.predefined_mask_weights=[1,1,1]", "min_T=30", "T=30"],
    "hpo": ["task=hpo", "task.meta_dataset=rpart", "head.std_min=0.05",
            "min_T=30", "T=30"]}
TASK_TRAIN_COMMON = ["batch_size=200", "dtype=bfloat16", "rollout_remat=true",
                     "burning_epoch=2", "max_epoch=5", "verbose=5",
                     "checkpoint=0"]


def within_sigmas(tag, what, got, want):
    """Hold the mean of ``got`` (rows) to that of ``want`` within SIGMAS
    combined standard errors; returns the record."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    se_g = got.std(ddof=1) / math.sqrt(got.size)
    se_w = want.std(ddof=1) / math.sqrt(want.size)
    limit = SIGMAS * math.sqrt(se_g ** 2 + se_w ** 2)
    diff = abs(got.mean() - want.mean())
    log(tag, f"{what}: {got.mean():.4f} ± {se_g:.4f} (SE, {got.size} rows), "
        f"the JAX package {want.mean():.4f} ± {se_w:.4f}: |diff| "
        f"{diff:.4f}, limit {limit:.4f}")
    if not diff <= limit:
        raise AssertionError(f"{tag} {what}: {got.mean():.4f} is {diff:.4f}"
                             f" from {want.mean():.4f} (limit {limit:.4f})")
    return dict(mean=got.mean(), se=se_g, jax_mean=want.mean(), jax_se=se_w,
                limit=limit)


def ces_fold_bound(terms):
    """The least time of the CES fold over ``terms`` (l, b, t) terms,
    fused in registers: the per-term count of
    ``portbench/counts/ces_fold.py`` (11 special-function results, 40
    float32 instructions) at this script's instruction rates.  Returns
    seconds (operations bound it)."""
    from portbench.counts.ces_fold import TERM_F32, TERM_SFU
    return max(terms * TERM_F32 / PEAK_F32_INSTR,
               terms * TERM_SFU / PEAK_MUFU_INSTR)


def phase_ces_bed(smi, M):
    """10: ``python -m aline_tpu_torch.eval_bed`` on ces_200k at the JAX
    run's protocol (T=15, L=1e7, n_query=2000, batch 100) with M rows,
    through its ``main``: final sPCE of the policy and of random designs
    within SIGMAS combined standard errors of the JAX package's on a TPU
    (M=2000 there), nmc >= pce - BED_NMC_SLACK in every row and step, one
    ``ces_eig_fold`` launch a chunk and no other kernel; wall time split
    into the rollout and the EIG stage,
    the EIG stage per batch against ``ces_fold_bound``, peak memory."""
    from aline_tpu_torch import eval_bed
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.eval import eig

    run_dir = run_copy("ces_bed_run", src=CES_RUN)
    cfg = load_config(run_dir)
    calls = []
    undo = patched([
        (eig, "get_traces", timed_calls(calls, "rollout", eig.get_traces)),
        (eig, "compute_eig_from_history", timed_calls(
            calls, "eig", eig.compute_eig_from_history)),
        (eval_bed, "compute_eig_from_history", timed_calls(
            calls, "eig", eval_bed.compute_eig_from_history))])
    argv = [run_dir, "--L", str(CES_BED["L"]), "--M", str(M),
            "--batch-size", str(CES_BED["batch_size"]), "--n-query",
            str(CES_BED["n_query"]), "--T", str(CES_BED["T"]), "--seed",
            str(CES_BED["seed"]), "--device", "cuda",
            "--with-random-baseline"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = eval_bed.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    want = expected_launches(cfg, ces_eig_fold=fold_chunks(calls))
    if counts != want:
        raise AssertionError(f"ces bed: kernel launches {counts}, "
                             f"expected {want}")
    n_batches = -(-M // CES_BED["batch_size"])
    rollouts = [c for c in calls if c["kind"] == "rollout"]
    eigs = [c for c in calls if c["kind"] == "eig"]
    if len(rollouts) != n_batches or len(eigs) != 2 * n_batches:
        raise AssertionError(f"ces bed: {len(rollouts)} rollouts and "
                             f"{len(eigs)} EIG calls for {n_batches} batches")
    cut = "" if M == 2000 else f" (M cut from 2000 to {M}: SEs are the run's)"
    rec = dict(M=M, wall_s=wall, peak_bytes=peak, launches=counts)
    for who in ("aline", "random"):
        m = {k: res[f"{who}_{k}"] for k in ("pce_mean", "pce_err",
                                           "nmc_mean", "nmc_err")}
        for k, v in m.items():
            if v.shape != (CES_BED["T"] + 1,) or not np.isfinite(v).all():
                raise AssertionError(f"ces bed {who} {k}: shape {v.shape}")
        path, key = JAX_CES[who]
        with np.load(path) as ref:
            want = float(ref[f"{key}pce_mean"][-1])
            want_se = float(ref[f"{key}pce_err"][-1])
        got, se = float(m["pce_mean"][-1]), float(m["pce_err"][-1])
        limit = SIGMAS * math.sqrt(want_se ** 2 + se ** 2)
        log("ces bed", f"{who} sPCE per step (mean ± SE): " + ", ".join(
            f"{a:.3f}±{b:.3f}" for a, b in zip(m["pce_mean"], m["pce_err"])))
        log("ces bed", f"{who}: final sPCE {got:.4f} ± {se:.4f} (SE, M={M})"
            f", the JAX package on a TPU {want:.3f} ± {want_se:.3f} "
            f"(M=2000): |diff| {abs(got - want):.4f}, limit {limit:.4f}"
            f"{cut}; final sNMC {float(m['nmc_mean'][-1]):.3f}")
        rec[who] = dict({k: v.tolist() for k, v in m.items()},
                        final_pce=got, final_se=se, jax_final_pce=want,
                        jax_final_se=want_se, limit=limit)
        if abs(got - want) > limit:
            raise AssertionError(f"ces bed {who}: final sPCE {got:.4f} is "
                                 f"{abs(got - want):.4f} from {want:.3f}")
    gap = min(float((c["nmc"] - c["pce"]).min()) for c in eigs)
    rec["min_nmc_minus_pce"] = gap
    if gap < -BED_NMC_SLACK:
        raise AssertionError(f"ces bed: nmc < pce - {BED_NMC_SLACK} ({gap})")
    rollout_s = sum(c["s"] for c in rollouts)
    eig_s = [c["s"] for c in eigs]
    terms = eigs[0]["L"] * eigs[0]["B"] * eigs[0]["Th"]
    bound_s = ces_fold_bound(terms)
    eig_ms = 1e3 * statistics.median(eig_s)
    rec.update(rollout_s=rollout_s, eig_s=sum(eig_s), eig_ms_per_batch=eig_ms,
               eig_ms_by_batch=[1e3 * s for s in eig_s],
               eig_bound_ms=1e3 * bound_s, eig_bound_by="operations",
               eig_terms_per_batch=terms)
    log("ces bed", f"nmc - pce over every row and step: least {gap:.3e} "
        f"(limit -{BED_NMC_SLACK}); {counts['ces_eig_fold']} ces_eig_fold "
        f"launches, one a chunk, and no other kernel")
    log("ces bed", f"M={M} B={CES_BED['batch_size']} n_query="
        f"{CES_BED['n_query']} T={CES_BED['T']} L={CES_BED['L']}: "
        f"{wall:.3f} s wall; rollout {rollout_s:.3f} s ({n_batches} "
        f"batches); EIG {sum(eig_s):.3f} s ({len(eigs)} calls: policy and "
        f"random), {eig_ms:.1f} ms a batch (median, {terms:.3e} terms) "
        f"against a fused bound of {1e3 * bound_s:.2f} ms (operations); "
        f"peak memory {peak / 2**30:.3f} GiB ({smi})")
    return rec


def censored_grid(seed, n, case):
    """loc, scale [n, 1] whose limits have z-scores in CENSORED_Z[case],
    and values [n, 8]: both limits, four inside, two just outside (the
    grid of tests/test_torch_ces.py)."""
    rng = np.random.default_rng(seed)
    eps, up = np.float32(CENSORED_EPS), np.float32(1 - CENSORED_EPS)
    logit_up = float(np.log(np.float64(up)) - np.log1p(-np.float64(up)))
    lo, hi = CENSORED_Z[case]
    if case == "body":
        z_l = rng.uniform(-hi, hi - 0.2, size=n)
        z_u = rng.uniform(z_l + 0.1, hi)
    else:
        z_l = -rng.uniform(lo, hi, size=n)
        z_u = rng.uniform(lo, hi, size=n)
    scale = 2 * logit_up / (z_u - z_l)
    loc = -logit_up - z_l * scale
    with np.errstate(over="ignore"):
        inside = np.clip(1 / (1 + np.exp(-(loc[:, None] + scale[:, None]
                                           * rng.normal(size=(n, 4))))),
                         1e-6, 1 - 1e-6)
    values = np.concatenate(
        [np.full((n, 1), eps), np.full((n, 1), up), inside,
         np.full((n, 1), np.nextafter(eps, np.float32(0))),
         np.full((n, 1), np.nextafter(up, np.float32(1)))], axis=1)
    f32 = np.float32
    return loc[:, None].astype(f32), scale[:, None].astype(f32), \
        values.astype(f32)


def censored_tolerance(loc, scale, values, ref):
    """1e-6 of max(|ref|, 1) plus 4 float32 ulps of the sizes of the
    log-density's terms (tests/test_torch_ces.py)."""
    v, loc, scale = (a.astype(np.float64) for a in (values, loc, scale))
    logs = np.abs(np.log(v)) + np.abs(np.log1p(-v))
    z = (np.log(v) - np.log1p(-v) - loc) / scale
    sizes = (1 + 0.5 * z * z + np.abs(z) * (logs + np.abs(loc)) / scale
             + logs + np.abs(np.log(scale)))
    return 1e-6 * np.maximum(np.abs(ref), 1) + 4 * F32_ULP * sizes


def ces_loglik_rounding(task, x, y, theta):
    """[..., B, Th] what float32 rounding may move the cumulative CES
    log-likelihood of designs x [B, Th, 6] and outcomes y [B, Th, 1] under
    theta [..., B, 5] by (in float64, on the CPU; a bound moves by theta_0's
    and by the contrastive draws' weighted by their share of its
    logsumexp): per step 4 ulps of the
    sizes that make the z-score, (|U(b1)| + |U(b2)|) u for mu (the
    utilities cancel in their difference) and |logit(y)|, over sigma, times
    |z| + 1, and of 0.5 z^2 and the logs; then summed over the steps.
    sigma goes down to 1e-5, so the z-score's rounding leads."""
    theta = theta[..., None, :]
    mu, sigma = (t.double() for t in task._response_params(x, theta))
    xi = torch.clamp(x, 0.01, 100.0)
    rho, alpha = theta[..., 0:1], theta[..., 1:4]
    u = torch.exp(theta[..., 4:5]).double()
    sizes = (task.utility(xi[..., :3], rho, alpha).double().abs()
             + task.utility(xi[..., 3:], rho, alpha).double().abs()) * u
    y = y.double()
    logit = torch.log(y) - torch.log1p(-y)
    z = (logit - mu) / sigma
    per_step = 4 * F32_ULP * ((z.abs() + 1) * (sizes + logit.abs() + 1)
                              / sigma + 0.5 * z * z + 20)
    return torch.cumsum(per_step[..., 0], dim=-1)


def phase_ces_witness():
    """10b: the card against the CPU: the censored log-density on a grid
    that covers both limits, the deep tail (|z| from 5.5 to 38) and beyond
    (to 200) and values outside the limits, in both tail modes; the CES
    bounds of card traces on CPU-drawn thetas within CES_BOUND_RTOL plus
    the log-likelihoods' rounding (``ces_loglik_rounding``); the
    peak memory of one chunk of the fold at the BED shape; one bound
    with any host synchronisation an error; one ``ces_eig_fold`` launch a
    chunk of the card's bounds."""
    from aline_tpu_torch.distributions.censored_sigmoid_normal import (
        CensoredSigmoidNormal)
    from aline_tpu_torch.eval.eig import chunk_size, compute_eig_from_history
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.ops.eig_fold_kernel import cum_loglik
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import load_model, weights_path

    rec = {}
    eps, up = CENSORED_EPS, 1 - CENSORED_EPS
    for mode in ("log_ndtr", "reference"):
        worst = 0.0
        for i, case in enumerate(CENSORED_Z):
            loc, scale, values = censored_grid(i, 2000, case)
            out = []
            for dev in ("cpu", "cuda"):
                d = CensoredSigmoidNormal(torch.from_numpy(loc).to(dev),
                                          torch.from_numpy(scale).to(dev),
                                          eps, up, tail_mode=mode)
                out.append(d.log_prob(torch.from_numpy(values).to(dev))
                           .cpu().numpy())
            cpu, card = out
            if not (np.isneginf(cpu[:, 6:]).all()
                    and np.isneginf(card[:, 6:]).all()
                    and np.isfinite(card[:, :6]).all()):
                raise AssertionError(f"ces witness {mode} {case}: limits")
            ratio = (np.abs(card[:, :6] - cpu[:, :6])
                     / censored_tolerance(loc, scale, values[:, :6],
                                          cpu[:, :6])).max()
            worst = max(worst, float(ratio))
            if ratio > 1:
                raise AssertionError(f"ces witness {mode} {case}: card vs "
                                     f"CPU at {ratio:.2f} of the tolerance")
        rec[f"censored_{mode}_worst_share_of_tolerance"] = worst
        log("ces witness", f"censored log-density, tail_mode={mode}: card "
            f"vs CPU on 3 x 2000 x 8 values (limits with |z| up to 200, "
            f"inside, outside): worst {worst:.3f} of the tolerance")

    run_dir = run_copy("ces_witness_run", src=CES_RUN)
    cfg, model = load_model(run_dir, weights_path(run_dir, "aline"), "cuda")
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = task.sample_batch(gen, CES_BED["batch_size"],
                              n_query=CES_BED["n_query"])
    reset_launches()
    theta0, x, y = get_traces(model, task, batch, CES_BED["T"])
    if any(launches().values()):
        raise AssertionError(f"ces witness: launches {launches()}")
    rows = CES_WITNESS_ROWS
    cpu_in = [t[:rows].cpu() for t in (theta0, x, y)]
    thetas = task.sample_theta(torch.Generator().manual_seed(2),
                               (CES_WITNESS_L, rows))
    # what float32 rounding may move the bounds by: theta_0's cumulative
    # log-likelihood's, twice, and the contrastive draws' weighted by
    # their share of the logsumexp
    S = cum_loglik(task.log_likelihood, cpu_in[1], cpu_in[2][..., 0], thetas,
                   CES_WITNESS_L)
    slack = (2 * ces_loglik_rounding(task, *cpu_in[1:], cpu_in[0])
             + (torch.softmax(S.double(), dim=0)
                * ces_loglik_rounding(task, *cpu_in[1:], thetas)).sum(0))
    for stepwise in (False, True):
        want = compute_eig_from_history(task, *cpu_in, 0, 0,
                                        stepwise=stepwise, thetas=thetas)
        got = compute_eig_from_history(
            task, *[t.cuda() for t in cpu_in], 0, 0, stepwise=stepwise,
            thetas=thetas.cuda())
        tol_s = slack if stepwise else slack[:, -1]
        for name, g, w in zip(("pce", "nmc"), got, want):
            err = (g.cpu() - w).abs()
            rel = float((err / w.abs().clamp_min(1.0)).max())
            share = float((err / (CES_BOUND_RTOL * w.abs().clamp_min(1.0)
                                  + tol_s)).max())
            key = f"{name}_{'stepwise' if stepwise else 'final'}"
            rec[f"{key}_rel"] = rel
            rec[f"{key}_share_of_tolerance"] = share
            log("ces witness", f"{name} on {CES_WITNESS_L} CPU-drawn thetas "
                f"({rows} rows, stepwise={stepwise}): card vs CPU max abs "
                f"{float(err.max()):.3e}, relative to max(|CPU|, 1) "
                f"{rel:.3e}; {share:.3f} of the tolerance ({CES_BOUND_RTOL}"
                f" relative plus the log-likelihoods' rounding, up to "
                f"{float(tol_s.max()):.3e})")
            if share > 1:
                raise AssertionError(f"ces witness: {name} off by {rel}")
    Lc = chunk_size(CES_BED["L"], x.shape[0], x.shape[1], 32_768)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    compute_eig_from_history(task, theta0, x, y, Lc, 3, stepwise=True)
    torch.cuda.synchronize()
    chunk_peak = torch.cuda.max_memory_allocated() - base
    rec.update(chunk_Lc=Lc, chunk_peak_bytes=chunk_peak)
    log("ces witness", f"one chunk of the fold at B={x.shape[0]}, "
        f"Th={x.shape[1]}: Lc={Lc}, a float32 [Lc, B, Th] block "
        f"{4 * Lc * x.shape[0] * x.shape[1] / 2**20:.0f} MiB, peak "
        f"{chunk_peak / 2**30:.3f} GiB above the traces")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pce, nmc = compute_eig_from_history(task, theta0, x, y, 100_000, 5,
                                            stepwise=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not (torch.isfinite(pce).all() and torch.isfinite(nmc).all()):
        raise AssertionError("ces witness: non-finite bounds")
    log("ces witness", "compute_eig_from_history at L=100000 on the card's "
        "draws under set_sync_debug_mode('error'): no host synchronisation")
    # one ces_eig_fold launch a chunk of the card's bounds (the two on
    # given thetas, the chunk's, the one under the sync check), no other
    want = (2 * math.ceil(CES_WITNESS_L / chunk_size(
        CES_WITNESS_L, rows, x.shape[1], 32_768)) + 1
        + math.ceil(100_000 / Lc))
    counts = launches()
    if counts != dict({k: 0 for k in counts}, ces_eig_fold=want):
        raise AssertionError(f"ces witness: launches {counts}, expected "
                             f"{want} of ces_eig_fold")
    rec["launches"] = counts
    log("ces witness", f"{want} ces_eig_fold launches, one a chunk of the "
        f"card's bounds, and no other kernel")
    return rec


def _psych_rows(curves, key):
    """The final step of ``key`` over every seed's rows."""
    return np.concatenate([
        curves[f"{'' if s == PSYCH['seeds'][0] else f'seed{s}_'}{key}"][:, -1]
        for s in PSYCH["seeds"]])


def phase_psych(smi):
    """11: ``eval_psychometric`` and ``eval_psi`` on psych_100k at the
    scripts' protocol (B=100, n_query=300, T=30, seeds 0, 1, 2, three
    masks), through their ``main``: each mask's (and strategy's) final mean
    LL and RMSE over the 300 rows within SIGMAS combined standard errors
    of the JAX package's curves; no kernel launched; wall times and peak
    memory; one PSI rollout under set_sync_debug_mode("error")."""
    from aline_tpu_torch import eval_psi, eval_psychometric
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.eval.psi import make_theta_grid, psi_rollout_curves
    from aline_tpu_torch.tasks import build_task

    run_dir = run_copy("psych_run", src=PSYCH_RUN)
    seeds = ",".join(str(s) for s in PSYCH["seeds"])
    common = ["--device", "cuda", "--batch-size", str(PSYCH["batch_size"]),
              "--n-query", str(PSYCH["n_query"]), "--T", str(PSYCH["T"]),
              "--seeds", seeds]
    rec = {}
    for name, fn, argv, ref_path, strategies in (
            ("psychometric", eval_psychometric.main, [run_dir, *common],
             JAX_PSYCH, ("",)),
            ("psi", eval_psi.main,
             [run_dir, *common, "--out", str(OUT_DIR / "psi_curves.npz")],
             JAX_PSI, ("_psi", "_random"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        curves = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
        if any(counts.values()):
            raise AssertionError(f"{name}: kernel launches {counts}")
        if name == "psi" and peak > PSI_PEAK_LIMIT:
            raise AssertionError(f"psi: peak memory {peak / 2**30:.3f} GiB "
                                 f"at --b-chunk 4, limit "
                                 f"{PSI_PEAK_LIMIT / 2**30:.0f} GiB")
        r = dict(wall_s=wall, peak_bytes=peak)
        with np.load(ref_path) as ref:
            for mask in PSYCH_MASKS:
                for strat in strategies:
                    for k in ("log_prob", "rmse"):
                        key = f"{mask}{strat}_{k}"
                        r[key] = within_sigmas(
                            name, f"{key} final", _psych_rows(curves, key),
                            _psych_rows(ref, key))
        log(name, f"B={PSYCH['batch_size']} n_query={PSYCH['n_query']} "
            f"T={PSYCH['T']} seeds {seeds}, 3 masks: {wall:.3f} s wall, "
            f"peak memory {peak / 2**30:.3f} GiB, no kernel launched ({smi})")
        rec[name] = r
    task = build_task(load_config(run_dir).task)
    grid = make_theta_grid(task, device="cuda")
    batch = task.sample_batch(torch.Generator(device="cuda").manual_seed(0),
                              PSYCH["batch_size"], n_query=PSYCH["n_query"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    for mask in ([True, True, False, False], [True] * 4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for strategy in ("psi", "random"):
                psi_rollout_curves(task, batch, 2, gen, mask=mask,
                                   strategy=strategy, grid=grid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    log("psi", "two-step PSI and random rollouts (a 2-parameter and the "
        "full target) under set_sync_debug_mode('error'): no host "
        "synchronisation")
    return rec


def phase_hpo(smi):
    """12: ``eval_hpo`` on each of the six HPO-B runs at the script's
    protocol (the benchmark's fixed test set, T=30, n_query=100,
    n_target=100, seed 0), through its ``main``: the policy's final mean
    LL and RMSE over the 30 rows within SIGMAS combined standard errors of
    the run's JAX curves; how many of the 30 policy rows leave the
    artifact's trajectory (the artifact holds no indices: a row leaves
    where its log-prob gap exceeds the largest gap at step 0, which the
    two bf16 forwards' rounding alone makes) and at what gap; no kernel
    launched; wall time per run."""
    from aline_tpu_torch import eval_hpo

    rec = {}
    for run, artifact in HPO_RUNS.items():
        run_dir = run_copy(f"{run}_run", src=ROOT / "checkpoints" / run)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        curves = eval_hpo.main([run_dir, "--device", "cuda", "--T",
                                str(HPO["T"]), "--n-query",
                                str(HPO["n_query"]), "--n-target",
                                str(HPO["n_target"]), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(launches().values()):
            raise AssertionError(f"hpo {run}: kernel launches {launches()}")
        r = dict(wall_s=wall)
        with np.load(ARTIFACTS / artifact) as ref:
            for k in ("log_prob", "rmse"):
                r[k] = within_sigmas(f"hpo {run}", f"aline final {k}",
                                     curves[f"aline_{k}"][:, -1],
                                     ref[f"aline_{k}"][:, -1])
            ours = curves["aline_log_prob"]
            gap = np.abs(ours - ref["aline_log_prob"][:, :ours.shape[1]])
        # step 0 conditions both on the same fixed rows: its gap is the two
        # bf16 forwards' rounding alone; a row whose gap later exceeds the
        # largest of those has left the artifact's trajectory
        floor = float(gap[:, 0].max())
        leaves = (gap > floor).any(axis=1)
        first = np.argmax(gap > floor, axis=1)
        r.update(step0_max_gap=floor, rows_leaving=int(leaves.sum()),
                 first_steps=first[leaves].tolist(),
                 gap_at_first=[float(gap[i, first[i]])
                               for i in np.flatnonzero(leaves)],
                 max_gap=float(gap.max()),
                 median_row_max_gap=float(np.median(gap.max(axis=1))))
        log(f"hpo {run}", f"log-prob gap to the artifact at step 0 (same "
            f"context, bf16 rounding alone) at most {floor:.4f}; "
            f"{int(leaves.sum())} of 30 policy rows exceed it later (first "
            f"steps {r['first_steps']}, gaps there "
            f"{[round(g, 4) for g in r['gap_at_first']]}); median of the "
            f"rows' largest gaps {r['median_row_max_gap']:.4f}, largest "
            f"{r['max_gap']:.4f}; {wall:.3f} s wall; no kernel launched "
            f"({smi})")
        rec[run] = r
    return rec


def phase_train_tasks(smi):
    """13: ``python -m aline_tpu_torch.train`` through its ``main`` on
    each new task's recipe (TASK_TRAIN_ARGS, bf16, B=200): finite losses,
    no kernel launched but CES's fold (one ``ces_eig_fold`` launch a chunk
    of its bounds), warm epoch ms and peak memory; CES's EIG hook once,
    finite, and its final bounds."""
    from aline_tpu_torch.eval import eig
    from aline_tpu_torch.train import __main__ as entry
    from aline_tpu_torch.train.loop import Trainer

    rec = {}
    for task, args in TASK_TRAIN_ARGS.items():
        out_dir = OUT_DIR / f"{task}_train_smoke"
        shutil.rmtree(out_dir, ignore_errors=True)
        calls = []
        epoch_fn = Trainer.train_epoch

        def timed_epoch(self, epoch, epoch_fn=epoch_fn, calls=calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = epoch_fn(self, epoch)
            torch.cuda.synchronize()
            calls.append(dict(kind="epoch", epoch=epoch, phase=self.phase,
                              s=time.perf_counter() - t0,
                              loss=float(m["loss"])))
            return m

        undo = patched([(Trainer, "train_epoch", timed_epoch),
                        (entry, "eval_boed", timed_calls(
                            calls, "eval_boed", entry.eval_boed)),
                        (eig, "compute_eig_from_history", timed_calls(
                            calls, "eig", eig.compute_eig_from_history))])
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            trainer = entry.main(args + TASK_TRAIN_COMMON
                                 + ["device=cuda", f"output_dir={out_dir}"])
            counts = launches()
            peak = torch.cuda.max_memory_allocated()
        finally:
            patched(undo)
        want = expected_launches(trainer.cfg,
                                 ces_eig_fold=fold_chunks(calls))
        if counts != want:
            raise AssertionError(f"train {task}: launches {counts}, "
                                 f"expected {want}")
        epochs = [c for c in calls if c["kind"] == "epoch"]
        if not all(math.isfinite(e["loss"]) for e in epochs):
            raise AssertionError(f"train {task}: losses {epochs}")
        warm_ms = 1e3 * statistics.median(
            [e["s"] for e in epochs if e["phase"] == "main"][1:])
        r = dict(epochs=epochs, warm_ms=warm_ms, peak_bytes=peak,
                 launches=counts)
        cfg = trainer.cfg
        msg = (f"B={cfg.batch_size} T={cfg.T} n_query_init="
               f"{cfg.task.n_query_init} {cfg.dtype}: epochs " + ", ".join(
                   f"{e['epoch']} ({e['phase']}) {1e3 * e['s']:.1f} ms"
                   for e in epochs) + f"; warm epoch {warm_ms:.1f} ms")
        if cfg.eval.EIG:
            recs = [json.loads(line) for line in
                    (out_dir / "metrics.jsonl").read_text().splitlines()]
            bounds = [b for b in recs if "pce_mean" in b]
            if len(bounds) != 1 or not all(
                    math.isfinite(bounds[0][k])
                    for k in ("pce_mean", "nmc_mean")):
                raise AssertionError(f"train {task}: bounds {bounds}")
            hook_s, final_s = (c["s"] for c in calls
                               if c["kind"] == "eval_boed")
            r.update(bounds=bounds[0], hook_s=hook_s, final_bounds_s=final_s)
            msg += (f"; EIG hook (L={cfg.eval.L}, M={cfg.eval.M}) "
                    f"{hook_s:.3f} s: sPCE {bounds[0]['pce_mean']:.4f}, "
                    f"sNMC {bounds[0]['nmc_mean']:.4f}; final bounds "
                    f"(M={cfg.eval.M_final}, L={cfg.eval.L_final}) "
                    f"{final_s:.3f} s")
        log(f"train {task}", msg + f"; peak memory {peak / 2**30:.3f} GiB; "
            f"kernel launches {counts} ({smi})")
        rec[task] = r
    return rec


# Phases 14-18 (the baselines and design paths of slice 9).  14: the
# classical GP baselines at scripts/eval_al.py's protocol on al1d_200k
# (bf16 policy; the baselines in float32): B, n_query, T, fit steps.  The
# smoke runs GP_SMOKE_B problems; ``--only gp`` the protocol's B.
GP = dict(batch_size=100, n_query=500, T=30, fit_steps=80)
GP_SMOKE_B = 25
# the card against the CPU on a small batch with fixed random scores; a
# row that chooses otherwise must do so where the CPU's scores of the two
# candidates lie within GP_TIE_REL of each other (relative)
GP_WITNESS = dict(batch_size=8, n_query=100, T=10)
GP_TIE_REL = 1e-3
# 15: the 1-D benchmark functions at the flagship's eval shape
BENCH_NAMES = ("forrester", "gramacy1d", "higdon")
BENCH = dict(batch_size=100, n_query=500, T=T_STEPS)
# Off the GP prior a single pool token's design score can move by many
# ulps between the card and the CPU while the others stay within one (a
# one-ulp change of two near-equal attention scores of a peaked softmax
# moves that token's output): the first run read 2114.7 ulps on higdon
# (PERF.md section 6), at a candidate of probability below e^-40
# on both devices.  Such a candidate cannot change a choice, so phase 15
# holds to BF16_CARD_ULPS the scores of candidates with a probability of
# at least BENCH_NEGLIGIBLE_P on either device and every posterior mean,
# and reads the rest apart.
BENCH_NEGLIGIBLE_P = 1e-6
# 16: scripts/train_continuous.py's DEFAULTS (location finding, B=200,
# T=30, float32, fresh init), 2 burning and 3 main epochs, final bounds of
# greedy rollouts at eval.L_final with M_final cut to 200
CONT_ARGS = ["burning_epoch=2", "max_epoch=5", "verbose=1", "checkpoint=0",
             "eval.EIG=true", "eval.M_final=200"]
CONT_PATHWISE = ["alpha=0", "alpha_pce=1", "pce_L=255"]
# 17: scripts/train_dad.py's DEFAULTS (B=256, T=30, eval.L=511), DAD_EPOCHS
# epochs, final bounds at eval.L_final with M_final cut to 200
DAD_EPOCHS = 150       # 300 until PR 15, cut to fit phase wide in the limit
DAD_ARGS = [f"max_epoch={DAD_EPOCHS}", "verbose=100", "checkpoint=0",
            "eval.M_final=200"]
# The card-vs-CPU training steps of 16 and 17 are held as phase 7 holds
# its step, on a small batch (PARITY_B), over PARITY_T steps and over the
# recipe's T.  The REINFORCE reward (train/loss.py) clamps each step's
# gain at 0 and divides it by the batch's spread of that step's gains: a
# step whose gains all lie near 0 turns their rounding into a reward of
# order 1, so the devices' rewards part where their inputs agree to an
# ulp (the first run's T=30 step read 1.355e-03 of the largest gradient
# element).  The reward is a constant to the gradient, so the card takes
# the CPU pass's (``cpu_reward``), and what its own would have moved is
# read beside the step.
PARITY_B, PARITY_T = 8, 5
# 18: the trend on loc_100k, bf16
TREND = dict(M=200, batch_size=100, n_query=2000,
             L_checkpoints=(10_000, 100_000, 1_000_000), seed=0)


def gp_witness(task, n_ctx):
    """14, the card against the CPU: the six methods on a small batch
    (GP_WITNESS) drawn on the CPU, with fixed uniform scores for
    ``random``; curves within 1e-3 wherever the two devices have chosen
    alike so far, and a row that chooses otherwise does so at a near tie
    of the CPU's scores.  Then two steps under
    ``set_sync_debug_mode("error")``."""
    from aline_tpu_torch.eval import gp_al_baselines as gpb
    W = GP_WITNESS
    g = torch.Generator().manual_seed(3)
    batch = task.sample_batch(g, W["batch_size"], n_query=W["n_query"])
    args = (batch.x, batch.y, batch.target_x,
            batch.target_all[:, :batch.n_target_data])
    uniform = torch.rand(W["T"], W["batch_size"], batch.n_points,
                         generator=g)
    t0 = time.perf_counter()
    cpu = gpb.compare_acquisition_methods(
        *args, n_ctx, W["T"], fit_steps=GP["fit_steps"], uniform=uniform,
        return_scores=True)
    cpu_s = time.perf_counter() - t0
    card_args = [a.cuda() for a in args]
    card_uniform = uniform.cuda()
    card = gpb.compare_acquisition_methods(
        *card_args, n_ctx, W["T"], fit_steps=GP["fit_steps"],
        uniform=card_uniform)
    rec, bad = {}, []
    for name, c in cpu.items():
        idx_c, idx_g = c["idx"], card[name]["idx"].cpu()
        differs, first = first_change(idx_g, idx_c)
        # steps 0..first of a row that leaves are still on the same state
        upto = torch.where(differs, first, torch.full_like(first, W["T"]))
        valid = torch.arange(W["T"] + 1)[None] <= upto[:, None]
        worst = frac = 0.0
        for k in ("rmse", "log_prob"):
            got, ref = card[name][k].cpu(), c[k]
            err = (got - ref).abs()
            share = (err / (1e-3 + 1e-3 * ref.abs()))[valid].max().item()
            if share > 1.0:
                bad.append(f"{name} {k}: off by {err[valid].max():.3e}")
            worst = max(worst, err[valid].max().item())
            frac = max(frac, share)
        gaps = []
        for r in torch.nonzero(differs)[:, 0].tolist():
            t = int(first[r])
            s = c["scores"][r, t]
            a, b = s[idx_c[r, t]], s[idx_g[r, t]]
            gaps.append(((a - b).abs() / a.abs().clamp_min(1e-30)).item())
        rec[name] = dict(max_abs_err=worst, tolerance_share=frac,
                         rows_differing=len(gaps),
                         max_tie_gap_rel=max(gaps, default=0.0))
        log("gp", f"{name}: card vs CPU ({W['batch_size']} rows, n_query="
            f"{W['n_query']}, T={W['T']}): curves within {frac:.3f} of "
            f"their tolerance, 1e-3 plus 1e-3 of the CPU's value (largest "
            f"|difference| {worst:.3e}) while the choices agree; "
            f"{len(gaps)} rows choose otherwise, at a "
            f"relative score gap of at most {max(gaps, default=0.0):.3e} "
            f"(limit {GP_TIE_REL})")
        if max(gaps, default=0.0) > GP_TIE_REL:
            bad.append(f"{name}: a row leaves at a score gap {max(gaps)}")
    if bad:
        raise AssertionError("gp witness: " + "; ".join(bad))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        two = gpb.compare_acquisition_methods(
            *card_args, n_ctx, 2, fit_steps=2, uniform=card_uniform[:2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(torch.isfinite(v["rmse"]).all() for v in two.values()):
        raise AssertionError("gp: non-finite curves under sync debug")
    log("gp", f"two steps of all six methods under "
        f"set_sync_debug_mode('error'): no host synchronisation; CPU "
        f"witness {cpu_s:.1f} s")
    return dict(methods=rec, cpu_s=cpu_s)


def phase_gp(smi, B):
    """14: ``eval_al``'s ``main`` with ``--with-gp-baselines`` on
    al1d_200k at scripts/eval_al.py's protocol with ``B`` problems (GP
    names B=100): finite curves, each deterministic method's final mean
    RMSE below its step 0's; the baselines' wall and peak memory; then
    ``gp_witness``."""
    from aline_tpu_torch import eval_al
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.eval.gp_al_baselines import ACQUISITION_FUNCTIONS
    from aline_tpu_torch.tasks import build_task

    run_dir = run_copy("gp_run")
    cfg = load_config(run_dir)
    calls = []
    undo = patched([(eval_al, "compare_acquisition_methods", timed_calls(
        calls, "gp", eval_al.compare_acquisition_methods))])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = eval_al.main([
            run_dir, "--device", "cuda", "--batch-size", str(B),
            "--n-query", str(GP["n_query"]), "--T", str(GP["T"]),
            "--gp-fit-steps", str(GP["fit_steps"]), "--with-gp-baselines"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    if counts != expected_launches(cfg):
        raise AssertionError(f"gp: launches {counts}, expected none")
    gp_s = calls[0]["s"]
    cut = "" if B == GP["batch_size"] else (
        f" (B cut from {GP['batch_size']} to {B}: ``--only gp`` runs "
        f"the protocol's B)")
    rec = dict(B=B, wall_s=wall, gp_s=gp_s, peak_bytes=peak,
               launches=counts, methods={})
    for name in ACQUISITION_FUNCTIONS:
        rm, lp = res[f"gp_{name}_rmse"], res[f"gp_{name}_log_prob"]
        if rm.shape != (B, GP["T"] + 1) or not (
                np.isfinite(rm).all() and np.isfinite(lp).all()):
            raise AssertionError(f"gp {name}: curves {rm.shape}, finite "
                                 f"{np.isfinite(rm).all()}")
        r0, rT = float(rm[:, 0].mean()), float(rm[:, -1].mean())
        rec["methods"][name] = dict(rmse_step0=r0, rmse_final=rT,
                                    ll_final=float(lp[:, -1].mean()))
        log("gp", f"{name}: mean rmse step 0 {r0:.4f}, step {GP['T']} "
            f"{rT:.4f}; final log_prob {lp[:, -1].mean():.4f}")
        if name != "random" and not rT < r0:
            raise AssertionError(f"gp {name}: the final rmse {rT:.4f} is "
                                 f"not below step 0's {r0:.4f}")
    n_m = len(ACQUISITION_FUNCTIONS)
    log("gp", f"B={B} n_query={GP['n_query']} T={GP['T']} fit_steps="
        f"{GP['fit_steps']}{cut}: the six baselines {gp_s:.3f} s in one "
        f"batched fit ({n_m * B} problems; {gp_s / n_m:.3f} s a method), "
        f"eval_al {wall:.3f} s; peak memory {peak / 2**30:.3f} GiB; no "
        f"kernel launched ({smi})")
    rec["witness"] = gp_witness(build_task(cfg.task),
                                cfg.task.n_context_init)
    return rec


def phase_bench(smi):
    """15: ``eval_al --benchmark`` for the 1-D functions on al1d_200k in
    its bf16 (n_query=500): finite curves, aline's final RMSE below its
    step 0's, no kernel; the card against the CPU over BF16_WITNESS_ROWS
    rows along the CPU's trajectory on a benchmark batch
    (``hold_trajectory``, as phase 4c)."""
    from aline_tpu_torch import eval_al
    from aline_tpu_torch.eval.al_curves import STRATEGIES, al_rollout_curves
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    run_dir = run_copy("bench_run")
    cfg, model = load_model(run_dir, AL1D_200K_PARAMS, "cuda")
    _, model_cpu = load_model(run_dir, AL1D_200K_PARAMS, "cpu")
    rec, total = {}, {name: 0 for name in launches()}
    for name in BENCH_NAMES:
        reset_launches()
        t0 = time.perf_counter()
        res = eval_al.main([
            run_dir, "--device", "cuda", "--batch-size",
            str(BENCH["batch_size"]), "--n-query", str(BENCH["n_query"]),
            "--T", str(BENCH["T"]), "--benchmark", name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        if counts != expected_launches(cfg):
            raise AssertionError(f"bench {name}: launches {counts}")
        r = {}
        for s in STRATEGIES:
            rm = res[f"bench_{name}_{s}_rmse"]
            if rm.shape != (BENCH["batch_size"], BENCH["T"] + 1) or \
                    not np.isfinite(rm).all():
                raise AssertionError(f"bench {name} {s}: {rm.shape}")
            r[s] = (float(rm[:, 0].mean()), float(rm[:, -1].mean()))
        log("bench", f"{name}: mean rmse step 0 -> {BENCH['T']}: " + ", ".join(
            f"{s} {a:.4f} -> {b:.4f}" for s, (a, b) in r.items())
            + f"; eval_al {wall:.3f} s")
        if not r["aline"][1] < r["aline"][0]:
            raise AssertionError(f"bench {name}: aline's rmse did not fall")
        gen = torch.Generator(device="cuda").manual_seed(7)
        bbatch = eval_al.benchmark_batch(cfg.task, name, BENCH["n_query"],
                                         gen, BENCH["batch_size"])
        card = al_rollout_curves(model, bbatch, BENCH["T"], strategy="aline")
        rows = BF16_WITNESS_ROWS
        witness = al_rollout_curves(model_cpu,
                                    batch_rows(bbatch, rows, "cpu"),
                                    BENCH["T"], strategy="aline")
        held = hold_trajectory(
            f"bench {name}", bbatch, witness["idx"], model_cpu,
            {"card": (model, card["idx"][:rows])}, rows, BF16_CARD_ULPS,
            T=BENCH["T"], negligible_p=BENCH_NEGLIGIBLE_P)
        rec[name] = dict(rmse={s: list(v) for s, v in r.items()},
                         wall_s=wall, against_cpu=held["card"])
        for k in total:
            total[k] += counts[k]
    rec["launches"] = total
    log("bench", f"B={BENCH['batch_size']} n_query={BENCH['n_query']} "
        f"T={BENCH['T']} {cfg.dtype}: no kernel launched ({smi})")
    return rec


def grads_agree(label, g_c, g_g):
    """(the largest |card - CPU| gradient element, that over the largest
    CPU element); every element within 1e-4 of the CPU's plus 1e-4 of the
    model's largest CPU gradient element."""
    scale = max(g.abs().max() for g in g_c.values())
    worst = 0.0
    for n, g in g_c.items():
        err = (g_g[n] - g).abs()
        if not bool((err <= TOL * g.abs() + TOL * scale).all()):
            raise AssertionError(f"{label}: grad of {n} differs between "
                                 f"CPU and card by {err.max():.3e}")
        worst = max(worst, err.max().item())
    return worst, worst / scale.item()


def card_step(label, loss_fn, model_cpu, draws, T):
    """One step's loss and gradients of ``model_cpu`` on the CPU and of a
    copy on the card, on the same ``draws`` (moved to each device), the
    CPU first: losses within 1e-4 and gradients as ``grads_agree``;
    returns the readings and the card's launches."""
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    out = {}
    for dev, model in (("cpu", model_cpu), ("cuda", model_gpu)):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = loss_fn(model, [d.to(dev) if d is not None else None
                               for d in draws])
        loss.backward()
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None}, launches())
    (l_c, g_c, _), (l_g, g_g, counts) = out["cpu"], out["cuda"]
    if abs(l_g - l_c) > TOL + TOL * abs(l_c):
        raise AssertionError(f"{label}: loss CPU {l_c:.6f}, card {l_g:.6f}")
    worst, rel = grads_agree(label, g_c, g_g)
    log(label.split()[0], f"{label}: one step, B={PARITY_B} T={T}: loss "
        f"CPU {l_c:.6f}, card {l_g:.6f}; grads within {worst:.3e} ("
        f"{rel:.3e} of the largest); card launches {counts}")
    return dict(T=T, loss_cpu=l_c, loss_card=l_g,
                grad_max_abs_err=worst, grad_err_over_largest=rel,
                launches=counts)


def cpu_reward(seen, by_order=False):
    """``total_loss`` whose REINFORCE reward comes from the CPU pass: the
    CPU's call keeps its ``nll_query`` in ``seen``, the card's takes it in
    place of its own (the reward is detached, so the gradient sees a
    constant either way) and reads into ``seen`` what its own would have
    changed: the gains whose clamp at 0 it sets otherwise (``flips``) and
    the design loss (``design_loss_move``).  ``by_order``: the first call
    is the reference and every later one takes its reward, on whichever
    device."""
    from aline_tpu_torch.train.loss import reinforce_losses, total_loss

    def loss(ro, gamma, alpha_design, *rest):
        own = ro.nll_query.detach()
        first = "cpu" not in seen if by_order else own.device.type == "cpu"
        if first:
            seen["cpu"] = own.cpu()
            return total_loss(ro, gamma, alpha_design, *rest)
        ref, mine = seen["cpu"], own.cpu()
        ro_ref = ro._replace(nll_query=ref.to(own.device))
        seen.update(
            flips=int(((ref[:-1] - ref[1:] > 0)
                       != (mine[:-1] - mine[1:] > 0)).sum()),
            nll_query_max_abs_err=(mine - ref).abs().max().item(),
            design_loss_move=abs(reinforce_losses(ro, gamma)[0].item()
                                 - reinforce_losses(ro_ref, gamma)[0].item()))
        return total_loss(ro_ref, gamma, alpha_design, *rest)
    return loss


def cont_step_parity(label, extra):
    """16: one continuous training step (main phase) on the CPU (plain
    versions) and on the card (kernels) from the same fresh model and the
    same CPU-drawn batch and noises, the reward the CPU's (``cpu_reward``):
    held (``card_step``) at PARITY_T steps and at the recipe's T."""
    from aline_tpu_torch import train_continuous as tcm
    from aline_tpu_torch.config import parse_overrides
    rec = {}
    for T in (PARITY_T, None):
        cfg = parse_overrides(tcm.DEFAULTS + extra + [
            f"batch_size={PARITY_B}"] + ([f"T={T}", f"min_T={T}"] if T
                                          else []))
        tr = tcm.ContinuousTrainer(cfg, device="cpu")
        seen = {}

        def loss_fn(model, draws, tr=tr, cfg=cfg, seen=seen):
            undo = patched([(tcm, "total_loss", cpu_reward(seen))])
            try:
                return tcm.continuous_loss(model, tr.task, cfg, *draws,
                                           alpha=cfg.alpha,
                                           design_on=1.0)[0]
            finally:
                patched(undo)

        r = card_step(f"cont {label}", loss_fn, tr.model, tr.draw(PARITY_B),
                      cfg.T)
        r.update(reward_flips=seen["flips"],
                 nll_query_max_abs_err=seen["nll_query_max_abs_err"],
                 design_loss_move=seen["design_loss_move"])
        log("cont", f"cont {label}, T={cfg.T}: the card's own nll_query "
            f"within {seen['nll_query_max_abs_err']:.3e} of the CPU's; as "
            f"its reward it would have flipped {seen['flips']} of the "
            f"{(cfg.T - 1) * PARITY_B} clamps and moved the REINFORCE "
            f"design loss by {seen['design_loss_move']:.3e}")
        rec[f"T{cfg.T}"] = r
    return rec


def final_bounds_rows(calls):
    """(least nmc - pce over the rows of the EIG calls in ``calls``)."""
    eigs = [c for c in calls if c["kind"] == "eig"]
    return min(float((c["nmc"] - c["pce"]).min()) for c in eigs)


def check_final_bounds(label, bounds):
    pce, nmc = float(bounds["pce_mean"]), float(bounds["nmc_mean"])
    if not (math.isfinite(pce) and math.isfinite(nmc)) or \
            nmc < pce - BED_NMC_SLACK:
        raise AssertionError(f"{label}: final bounds {bounds}")
    return pce, nmc


def phase_cont(smi):
    """16: ``train_continuous``'s ``main`` at its DEFAULTS, REINFORCE and
    pathwise: per epoch exactly 2T GMM forwards and T backwards (the
    target tokens per step, once more in the recompute), T forwards per
    greedy eval batch; finite losses; final bounds finite with nmc >= pce
    - 1e-5; warm epoch ms, peak memory, the final bounds' wall; then one
    step on the card against one on the CPU for each objective."""
    from aline_tpu_torch import train_continuous as tcm
    from aline_tpu_torch.eval import eig

    rec = {}
    for label, extra in (("reinforce", []), ("pathwise", CONT_PATHWISE)):
        out_dir = OUT_DIR / f"cont_{label}_smoke"
        shutil.rmtree(out_dir, ignore_errors=True)
        calls = []
        epoch_fn = tcm.ContinuousTrainer.train_epoch
        greedy_fn = tcm.ContinuousTrainer.greedy_traces

        def timed_epoch(self, epoch, epoch_fn=epoch_fn, calls=calls):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            m = epoch_fn(self, epoch)
            torch.cuda.synchronize()
            calls.append(dict(kind="epoch", epoch=epoch, phase=self.phase,
                              s=time.perf_counter() - t0,
                              loss=float(m["loss"]), launches=launches()))
            return m

        def timed_greedy(self, *a, greedy_fn=greedy_fn, calls=calls):
            reset_launches()
            out = greedy_fn(self, *a)
            calls.append(dict(kind="greedy", launches=launches()))
            return out

        undo = patched([
            (tcm.ContinuousTrainer, "train_epoch", timed_epoch),
            (tcm.ContinuousTrainer, "greedy_traces", timed_greedy),
            (tcm, "eval_final_bounds", timed_calls(calls, "bounds",
                                                   tcm.eval_final_bounds)),
            (eig, "compute_eig_from_history", timed_calls(
                calls, "eig", eig.compute_eig_from_history))])
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = tcm.main(CONT_ARGS + extra + ["device=cuda",
                                                f"output_dir={out_dir}"])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            # since the greedy rollout's reset: it and the final bounds
            after_greedy = launches()
        finally:
            patched(undo)
        cfg = run["trainer"].cfg
        T = cfg.T
        epochs = [c for c in calls if c["kind"] == "epoch"]
        per_epoch = expected_launches(cfg, gmm_head_fwd=2 * T,
                                      gmm_head_bwd=T)
        for e in epochs:
            if e["launches"] != per_epoch or not math.isfinite(e["loss"]):
                raise AssertionError(f"cont {label} epoch {e['epoch']}: "
                                     f"launches {e['launches']}, expected "
                                     f"{per_epoch}; loss {e['loss']}")
        greedy = [c for c in calls if c["kind"] == "greedy"][0]["launches"]
        n_greedy = -(-cfg.eval.M_final // cfg.eval.batch_size_final)
        if greedy != expected_launches(
                cfg, gmm_head_fwd=n_greedy * cfg.eval.T_final):
            raise AssertionError(f"cont {label}: greedy launches {greedy}")
        folds = after_greedy["loc_eig_fold"]
        if folds != fold_chunks(calls):
            raise AssertionError(f"cont {label}: {folds} loc_eig_fold "
                                 f"launches in the final bounds, expected "
                                 f"{fold_chunks(calls)}")
        pce, nmc = check_final_bounds(f"cont {label}", run["bounds"])
        least = final_bounds_rows(calls)
        bounds_s = [c["s"] for c in calls if c["kind"] == "bounds"][0]
        warm_ms = 1e3 * statistics.median(
            [e["s"] for e in epochs if e["phase"] == "main"][1:])
        totals = {k: sum(e["launches"][k] for e in epochs) + greedy[k]
                  for k in greedy}
        totals["loc_eig_fold"] += folds
        rec[label] = dict(epochs=epochs, warm_ms=warm_ms, wall_s=wall,
                          peak_bytes=peak, final_pce=pce, final_nmc=nmc,
                          least_row_nmc_minus_pce=least,
                          final_bounds_s=bounds_s, launches=totals,
                          greedy_launches=greedy)
        log("cont", f"{label}: B={cfg.batch_size} T={T} {cfg.dtype}: epochs "
            + ", ".join(f"{e['epoch']} ({e['phase']}) {1e3 * e['s']:.1f} ms"
                        for e in epochs)
            + f"; {2 * T} GMM forwards and {T} backwards every epoch, "
            f"{greedy['gmm_head_fwd']} forwards in {n_greedy} greedy "
            f"batches; warm epoch {warm_ms:.1f} ms; final bounds ({folds} "
            f"fold launches, one a chunk; L="
            f"{cfg.eval.L_final:g}, M={cfg.eval.M_final}, batch "
            f"{cfg.eval.batch_size_final}, T={cfg.eval.T_final}) "
            f"{bounds_s:.3f} s: sPCE {pce:.4f}, sNMC {nmc:.4f} (least row "
            f"nmc - pce {least:.3e}); peak memory {peak / 2**30:.3f} GiB "
            f"({smi})")
        rec[f"{label}_parity"] = cont_step_parity(f"{label} step parity",
                                                  extra)
    return rec


def phase_dad(smi):
    """17: ``train_dad``'s ``main`` at its DEFAULTS for DAD_EPOCHS epochs:
    one ``loc_eig_fold`` launch a chunk of the bounds and no other
    kernel, finite final bounds with nmc >= pce - 1e-5,
    epochs/s and peak memory; one step on the card against one on the
    CPU (B=PARITY_B)."""
    from aline_tpu_torch import train_dad
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.eval import eig

    out_dir = OUT_DIR / "dad_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    calls = []
    undo = patched([
        (train_dad, "eval_final_bounds", timed_calls(
            calls, "bounds", train_dad.eval_final_bounds)),
        (eig, "compute_eig_from_history", timed_calls(
            calls, "eig", eig.compute_eig_from_history))])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run = train_dad.main(DAD_ARGS + ["device=cuda",
                                         f"output_dir={out_dir}"])
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    cfg = run["trainer"].cfg
    want = {name: 0 for name in counts}
    want["loc_eig_fold"] = fold_chunks(calls)
    if counts != want:
        raise AssertionError(f"dad: launches {counts}, expected {want}")
    pce, nmc = check_final_bounds("dad", run["bounds"])
    train_s = sum(run["epoch_s"])
    rate = len(run["epoch_s"]) / train_s
    bounds_s = [c["s"] for c in calls if c["kind"] == "bounds"][0]
    rec = dict(epochs=len(run["epoch_s"]), train_s=train_s,
               epochs_per_s=rate, peak_bytes=peak, final_pce=pce,
               final_nmc=nmc, least_row_nmc_minus_pce=final_bounds_rows(
                   calls), final_bounds_s=bounds_s, launches=counts)
    log("dad", f"B={cfg.batch_size} T={cfg.T} L={cfg.eval.L}: "
        f"{len(run['epoch_s'])} epochs in {train_s:.3f} s ({rate:.1f} "
        f"epochs/s); final bounds (L={cfg.eval.L_final:g}, M="
        f"{cfg.eval.M_final}) {bounds_s:.3f} s: sPCE {pce:.4f}, sNMC "
        f"{nmc:.4f}; peak memory {peak / 2**30:.3f} GiB; "
        f"{counts['loc_eig_fold']} fold launches, one a chunk, no other "
        f"kernel ({smi})")
    rec["parity"] = {}
    for T in (PARITY_T, cfg.T):
        cfg_p = parse_overrides(train_dad.DEFAULTS + [
            f"batch_size={PARITY_B}", f"T={T}"])
        tr = train_dad.DADTrainer(cfg_p, device="cpu")

        def loss_fn(model, draws, tr=tr):
            return train_dad.dad_loss(model, tr.task, *draws, 0.1)

        rec["parity"][f"T{T}"] = card_step(
            "dad step (explore_std 0.1)", loss_fn, tr.model,
            tr.draw(PARITY_B), T)
    return rec


def phase_trend(smi):
    """18: ``eval_bed_trend``'s ``main`` on loc_100k (bf16): nmc >= pce -
    1e-5 at every L; the row at the largest L equal bit for bit to
    ``eval_eig_from_history`` at that L on the same traces and seed; one
    ``loc_eig_fold`` launch a chunk and no other kernel; wall time."""
    from aline_tpu_torch import eval_bed_trend as ebt
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.eval.eig import (
        aggregate_bounds, derive_seed, eval_eig_from_history)
    from aline_tpu_torch.tasks import build_task

    run_dir = run_copy("trend_run", src=LOC_RUN)
    cfg = load_config(run_dir)
    traces = []

    def recorded(*a, **kw):
        out = ebt_get_traces(*a, **kw)
        traces.append(out)
        return out

    ebt_get_traces = ebt.get_traces
    calls = []
    undo = patched([(ebt, "get_traces", recorded),
                    (ebt, "compute_eig_from_history", timed_calls(
                        calls, "eig", ebt.compute_eig_from_history))])
    Ls = TREND["L_checkpoints"]
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = ebt.main([
            run_dir, "--device", "cuda", "--L-checkpoints",
            ",".join(str(L) for L in Ls), "--M", str(TREND["M"]),
            "--batch-size", str(TREND["batch_size"]), "--n-query",
            str(TREND["n_query"]), "--seed", str(TREND["seed"])])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        patched(undo)
    want = expected_launches(cfg, loc_eig_fold=fold_chunks(calls))
    if counts != want:
        raise AssertionError(f"trend: launches {counts}, expected {want}")
    rows = {}
    for key in res:
        if key.endswith("_pce"):
            L_eff = int(key[1:-4])
            pce, nmc = res[key], res[f"L{L_eff}_nmc"]
            rows[L_eff] = dict(pce=float(pce.mean()), nmc=float(nmc.mean()),
                               least_row_nmc_minus_pce=float(
                                   (nmc - pce).min()))
            if nmc.mean() < pce.mean() - BED_NMC_SLACK:
                raise AssertionError(f"trend L={L_eff}: nmc < pce")
    L = max(Ls)
    theta, x, y = (torch.cat(t) for t in zip(*traces))
    t0 = time.perf_counter()
    direct = eval_eig_from_history(
        build_task(cfg.task), theta, x, y, L, derive_seed(TREND["seed"], 1),
        batch_size=TREND["batch_size"])
    direct_s = time.perf_counter() - t0
    trend = aggregate_bounds([res[f"L{L}_pce"]], [res[f"L{L}_nmc"]], "se")
    if any(float(trend[k]) != float(direct[k]) for k in trend):
        raise AssertionError(f"trend: the L={L} row {trend} is not "
                             f"eval_eig_from_history's {direct}")
    log("trend", "L, mean sPCE, mean sNMC: " + "; ".join(
        f"{k} {v['pce']:.4f} {v['nmc']:.4f}" for k, v in sorted(
            rows.items())) + f"; the L={L} row equal bit for bit to "
        f"eval_eig_from_history ({direct_s:.3f} s); M={TREND['M']} batch "
        f"{TREND['batch_size']} n_query={TREND['n_query']} {cfg.dtype}: "
        f"{wall:.3f} s; {counts['loc_eig_fold']} fold launches, one a chunk"
        f" (the checkpoints read as the fold passes), no other kernel "
        f"({smi})")
    return dict(rows=rows, wall_s=wall, direct_s=direct_s, launches=counts)


# -- phases 22-24: the demo run (checkpoints/al1d_5k_demo) and its recipe,
# the native HPO-B loader --

DEMO_RUN_DIR = ROOT / "checkpoints" / "al1d_5k_demo"
# the seed study's eval protocol (scripts/seed_variance_report.py)
DEMO_EVAL = dict(batch_size=200, T=30, n_query=500, seed=0)
DEMO_WITNESS_ROWS = 4
JAX_DEMO = ARTIFACTS / "al1d_r3_final_eval_seed_variance.npz"
# the recipe cut short: burning to 30, checkpoint at 40, resumed to 60
# 30 epochs (60 until PR 15, cut to fit phase wide in the time limit)
DEMO_BURNING, DEMO_STOP = 15, 20
DEMO_SHORT = ["max_epoch=30", f"burning_epoch={DEMO_BURNING}",
              f"checkpoint={DEMO_STOP}", "verbose=5"]
HPOB_METAS = ("glmnet", "ranger", "ranger_shift", "rpart", "svm", "xgboost")


def phase_demo_eval(smi):
    """22: ``eval_al``'s ``main`` on checkpoints/al1d_5k_demo, its weights
    found through ``BANKED_RUNS``, at the seed study's protocol (data mask,
    B=200, T=30, n_query=500, seed 0), in its bf16: aline's final LL
    within SIGMAS combined standard errors of the study's seed-8 row (the
    JAX run of the same checkpoint on a TPU, other batches); no kernel
    launched (501 tokens: ``fused_gmm=auto`` takes the einsums); the card
    held to the CPU over DEMO_WITNESS_ROWS rows as 4c."""
    from aline_tpu_torch import eval_al
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        BANKED_RUNS, load_model, weights_path)

    run_dir = run_copy("demo_run", src=DEMO_RUN_DIR)
    npz = BANKED_RUNS["al1d_5k_demo"][1]
    if weights_path(run_dir, "aline") != str(npz):
        raise AssertionError("the demo's copy does not find its banked npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    curves = eval_al.main([
        run_dir, "--device", "cuda", "--mask", "data", "--batch-size",
        str(DEMO_EVAL["batch_size"]), "--T", str(DEMO_EVAL["T"]),
        "--n-query", str(DEMO_EVAL["n_query"]), "--seed",
        str(DEMO_EVAL["seed"])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"demo eval: kernel launches {counts}")
    rec = dict(wall_s=wall, peak_bytes=peak, launches=counts)
    with np.load(JAX_DEMO) as ref:
        rec["aline_final_ll"] = within_sigmas(
            "demo eval", "aline final LL (data mask)",
            curves["aline_log_prob"][:, -1],
            ref["seed8_aline_log_prob"][:, -1])
    finals = {k: float(curves[f"{k}"][:, -1].mean()) for k in
              ("aline_log_prob", "aline_rmse", "random_log_prob",
               "random_rmse", "uncertainty_log_prob", "uncertainty_rmse")}
    rec["finals"] = finals
    log("demo eval", f"B={DEMO_EVAL['batch_size']} n_query="
        f"{DEMO_EVAL['n_query']} T={DEMO_EVAL['T']} data mask: final "
        + ", ".join(f"{k} {v:.4f}" for k, v in finals.items())
        + f"; {wall:.3f} s wall, peak {peak / 2**30:.3f} GiB, no kernel "
        f"launched ({smi})")

    cfg, model = load_model(run_dir, npz, "cuda")
    _, model_cpu = load_model(run_dir, npz, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(DEMO_EVAL["seed"])
    batch = build_task(cfg.task).sample_batch(
        gen, DEMO_EVAL["batch_size"], n_query=DEMO_EVAL["n_query"])
    sel = torch.arange(batch.n_target, device="cuda") < batch.n_target_data
    batch = batch.replace(target_mask=sel)
    card = al_rollout_curves(model, batch, DEMO_EVAL["T"], strategy="aline")
    # the batch drawn again: read how far this rollout is from eval_al's
    rec["redrawn_max_abs_log_prob"] = float(np.abs(
        card["log_prob"].cpu().numpy() - curves["aline_log_prob"]).max())
    rows = DEMO_WITNESS_ROWS
    witness = al_rollout_curves(model_cpu, batch_rows(batch, rows, "cpu"),
                                DEMO_EVAL["T"], strategy="aline")
    rec["against_cpu"] = hold_trajectory(
        "demo eval", batch, witness["idx"], model_cpu,
        {"card": (model, card["idx"][:rows])}, rows, BF16_CARD_ULPS,
        T=DEMO_EVAL["T"])
    gap = (witness["log_prob"] - card["log_prob"][:rows].cpu()).abs()
    rec["witness_max_abs_log_prob"] = gap.max().item()
    log("demo eval", f"card vs CPU over {rows} rows: max |log-prob "
        f"difference| {rec['witness_max_abs_log_prob']:.3e}; the batch "
        f"drawn again, aline's curves within "
        f"{rec['redrawn_max_abs_log_prob']:.3e} of eval_al's")
    return rec


class _Stopped(Exception):
    """A training run stopped on purpose (``_stopping``)."""


def _stopping(epoch):
    """A ``Trainer.train_epoch`` that raises at ``epoch``: a run that stops
    there, after the checkpoint written at its start."""
    from aline_tpu_torch.train.loop import Trainer
    real = Trainer.train_epoch

    def stopping(self, e):
        if e == epoch:
            raise _Stopped(epoch)
        return real(self, e)
    return stopping


def phase_demo_train(smi):
    """23: ``train``'s ``main`` on the demo recipe (``seed_study``
    DEMO_RECIPE: seed 8, B=200, T=30, bf16), cut to DEMO_SHORT: straight
    to 30 epochs, and stopped at DEMO_STOP then resumed to 30 from its
    checkpoint; the resumed run's parameters against the straight run's
    (read; the CPU test holds resume bit for bit), finite losses on both
    sides of the burning switch, epoch ms of both phases from
    metrics.jsonl, the straight run's peak memory and launches, and
    ``scripts/plateau_report.py`` reading the run."""
    from aline_tpu_torch.seed_study import (
        DEMO_RECIPE, epoch_seconds, likelihood_by_step, metric_records)
    from aline_tpu_torch.train.__main__ import main as train_main

    def argv(name):
        out = OUT_DIR / name
        shutil.rmtree(out, ignore_errors=True)
        return list(DEMO_RECIPE) + DEMO_SHORT + [
            f"output_dir={out}", "load_checkpoint=true"], out

    args, straight_dir = argv("demo_train_straight")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    straight = train_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"demo train: kernel launches {counts}")
    args_r, resumed_dir = argv("demo_train_resumed")
    from aline_tpu_torch.train.loop import Trainer
    undo = patched([(Trainer, "train_epoch", _stopping(DEMO_STOP))])
    try:
        train_main(args_r)
    except _Stopped:
        pass
    else:
        raise AssertionError(f"demo train: no stop at {DEMO_STOP}")
    finally:
        patched(undo)
    resumed = train_main(args_r)
    if resumed.start_epoch != DEMO_STOP:
        raise AssertionError(f"demo train: resumed at {resumed.start_epoch}")
    diffs = {n: (p - q).abs().max().item() for (n, p), q in zip(
        straight.model.named_parameters(), resumed.model.parameters())}
    worst = max(diffs, key=diffs.get)
    recs = metric_records(str(straight_dir / "metrics.jsonl"))
    burning = DEMO_BURNING
    losses = {r["step"]: r["loss"] for r in recs}
    sides = ([s for s in losses if s < burning],
             [s for s in losses if s >= burning])
    if not all(sides) or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"demo train: losses {losses}")
    ll = likelihood_by_step(recs)
    per = epoch_seconds(recs, burning)
    ms = {p: 1e3 * statistics.median(v) for p, v in per.items()}
    report = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "plateau_report.py"),
         str(straight_dir)], capture_output=True, text=True, timeout=120)
    row = [ln for ln in report.stdout.splitlines()
           if str(straight_dir) in ln]
    if report.returncode != 0 or len(row) != 1 or \
            row[0].split()[1] != str(max(ll)):
        raise AssertionError(f"demo train: plateau_report read "
                             f"{report.stdout!r} {report.stderr!r}")
    rec = dict(wall_s=wall, peak_bytes=peak, launches=counts,
               epoch_ms=ms, likelihood=ll, resume_max_abs=diffs[worst],
               resume_worst=worst, resume_bitwise=not any(diffs.values()),
               plateau_report=row[0])
    log("demo train", f"{' '.join(DEMO_SHORT)}: {wall:.3f} s straight, "
        f"epoch {ms['burning']:.1f} ms burning, {ms['main']:.1f} ms main "
        f"(medians of {len(per['burning'])} and {len(per['main'])} "
        f"intervals), peak {peak / 2**30:.3f} GiB, no "
        f"kernel launched; losses finite on both sides of the switch; "
        f"stopped at {DEMO_STOP} and resumed: parameters within "
        f"{diffs[worst]:.3e} of the straight run (worst {worst}; bitwise "
        f"{rec['resume_bitwise']}); plateau_report: {row[0].split()[1:4]} "
        f"({smi})")
    return rec


def phase_hpob(smi):
    """24: ``csrc/hpob_loader.cpp`` built by the host's g++ on this
    machine; on the six meta-train files HPOB opens, the native arrays
    bit for bit the ``json`` path's (dtypes, shapes, dataset order); both
    paths timed (median of 3 reads)."""
    from aline_tpu_torch.ops import _build
    from aline_tpu_torch.tasks import hpob_native

    t0 = time.perf_counter()
    path = _build.build_host(hpob_native.EXTENSION)
    build_s = time.perf_counter() - t0
    rec = dict(build_s=build_s, library=path.name, files={})
    for meta in HPOB_METAS:
        src = str(ROOT / "data" / "HPOB" / f"{meta}.json")
        times = {}
        for native in (True, False):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                arrays = hpob_native.load_hpob_arrays(src, native=native)
                runs.append(time.perf_counter() - t0)
            times[native] = (statistics.median(runs), arrays)
        got, want = times[True][1], times[False][1]
        equal = list(got) == list(want) and all(
            g.dtype == w.dtype and g.shape == w.shape
            and np.array_equal(g, w)
            for did in want for g, w in zip(got[did], want[did]))
        if not equal:
            raise AssertionError(f"hpob {meta}: native arrays differ from "
                                 f"the json path's")
        rec["files"][meta] = dict(datasets=len(got),
                                  native_ms=1e3 * times[True][0],
                                  json_ms=1e3 * times[False][0])
    log("hpob", f"built {path.name} in {build_s:.2f} s; native == json "
        f"bit for bit on {len(HPOB_METAS)} files; ms native/json: "
        + ", ".join(f"{m} {r['native_ms']:.2f}/{r['json_ms']:.2f}"
                    for m, r in rec["files"].items()) + f" ({smi})")
    return rec


# -- multi-process phases (19 dp, 20 mesh, 21 seq; the trainer's settings) --

# Phases 19-21 run their ranks as processes of one spawn (``run_ranks``):
# gloo ranks that share cuda:0, since NCCL cannot put two ranks on one card
DIST_WORLD = 3
DIST_TIMEOUT_S = 600
DP_T = 30                      # the recipe's T: one f32 step held at it
# 19b: bench.py's recipe in bf16 with every kernel on the path: the GMM
# pair (fused_gmm=on: the 102 targets take it in bf16 too) and the bf16
# flash pair
DP_BF16_STEP = ["dtype=bfloat16", "head.fused_gmm=on",
                "encoder.attention_impl=flash"]
DP_BF16_ARGS = DP_BF16_STEP + ["max_epoch=4", "mesh_data=2"]
SEQ_RANKS = 3                  # 2001 = 3 x 667 pool tokens
# 21b: the float32 control of the flash traces, on the first rows of the
# batch (bitwise equal to the unsharded ones, or not: reported)
SEQ_F32_ROWS = 8


# Phase 25: the live cell's experiment and the eval cell's batch (one
# strategy), each on GRAPH_REPS batches of its shape
GRAPH_CASES = {"live": (1, 200), "eval": (BATCH, N_QUERY)}
GRAPH_REPS = 5
# and the training cells' epoch: B, n_query, under each attention core
TRAIN_GRAPH_CASES = {"train": "compact", "train_flash": "flash"}
TRAIN_GRAPH_SHAPE = (200, 200)
TRAIN_GRAPH_EPOCHS = 6


def device_ops(fn):
    """(the device operations, kernels, copies and fills, that a
    ``torch.profiler`` trace of ``fn()`` shows; the union of their
    intervals, ms)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import busy_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(dev), busy_us(dev) / 1e3


def phase_graph(smi):
    """25: the AL rollout through its CUDA graph against its eager steps
    (the docstring's phase 25): {case: record}."""
    from aline_tpu_torch.eval import al_curves
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model = load_model(RUN_DIR, AL1D_200K_PARAMS, "cuda")
    task = build_task(cfg.task)
    rec = {}
    for case, (B, n_query) in GRAPH_CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(25)
        batches = [task.sample_batch(gen, B, n_query=n_query)
                   for _ in range(GRAPH_REPS + 1)]

        def eager(b):
            with torch.no_grad():
                return al_curves._rollout(model, b, None, None, T_STEPS,
                                          "aline", cfg.time_token,
                                          *al_curves.fixed_by_batch(b))

        def graphed(b):
            return al_curves.al_rollout_curves(model, b, T_STEPS,
                                               time_token=cfg.time_token)

        def host_ms(fn, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = {k: v.cpu() for k, v in fn(b).items()}
            return 1e3 * (time.perf_counter() - t0), out

        eager(batches[0])                       # warm: kernels built
        torch.cuda.reset_peak_memory_stats()
        eager_runs = [host_ms(eager, b) for b in batches[1:]]
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first_ms, _ = host_ms(graphed, batches[0])
        capture_peak = torch.cuda.max_memory_allocated()
        graph_runs = [host_ms(graphed, b) for b in batches[1:]]
        for (_, want), (_, got) in zip(eager_runs, graph_runs):
            for k in want:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"graph {case}: {k} differs from "
                                         f"the eager rollout's")
        eager_med = statistics.median(t for t, _ in eager_runs)
        graph_med = statistics.median(t for t, _ in graph_runs)
        n_eager, busy_eager = device_ops(lambda: eager(batches[1]))
        n_graph, busy_graph = device_ops(lambda: graphed(batches[1]))
        rec[case] = dict(
            B=B, n_query=n_query, T=T_STEPS, strategy="aline",
            eager_ms=[t for t, _ in eager_runs],
            graph_ms=[t for t, _ in graph_runs], eager_ms_median=eager_med,
            graph_ms_median=graph_med, first_call_ms=first_ms,
            capture_ms=first_ms - eager_med, device_ops_eager=n_eager,
            device_ops_replay=n_graph, device_busy_ms_eager=busy_eager,
            device_busy_ms_replay=busy_graph, peak_bytes_eager=eager_peak,
            peak_bytes_capture=capture_peak)
        log("graph", f"{case} B={B} n_query={n_query} T={T_STEPS} aline: "
            f"eager {eager_med:.2f} ms, graph {graph_med:.2f} ms (median "
            f"of {GRAPH_REPS}, host clock, curves on the host), capture "
            f"{first_ms - eager_med:.1f} ms once; profiler: {n_eager} "
            f"device ops eager ({busy_eager:.2f} ms busy), {n_graph} in "
            f"one replay ({busy_graph:.2f} ms busy); peak "
            f"{eager_peak / 1e9:.2f} GB eager, {capture_peak / 1e9:.2f} GB "
            f"with the capture; replays bitwise eager ({smi})")
    for case, attention in TRAIN_GRAPH_CASES.items():
        rec[case] = _train_graph_case(smi, case, attention)
    return rec


def _train_graph_case(smi, case, attention):
    """Phase 25's training half for one attention core: {record}."""
    import logging

    from aline_tpu_torch.config import config_from_dict, load_config, to_dict
    from aline_tpu_torch.train import loop
    from aline_tpu_torch.train import rollout as eager_rollout
    B, n_query = TRAIN_GRAPH_SHAPE
    d = to_dict(load_config(str(RUN_DIR)))
    d.update(batch_size=B, T=T_STEPS, min_T=T_STEPS, burning_epoch=0,
             max_epoch=1000, checkpoint=0, load_checkpoint=False,
             verbose=1000, output_dir=tempfile.mkdtemp(prefix="smoke_tg_"))
    d["task"] = dict(d["task"], n_query_init=n_query, attend_to="data")
    d["encoder"] = dict(d["encoder"], attention_impl=attention)
    cfg = config_from_dict(d)
    orig = loop.rollout
    runs = {}
    for side, fn in (("eager", eager_rollout.rollout), ("graph", orig)):
        loop.rollout = fn
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr = loop.Trainer(cfg, logger=logging.getLogger("chip_smoke"),
                              device="cuda")
            ms, states = [], []
            for e in range(TRAIN_GRAPH_EPOCHS):
                t0 = time.perf_counter()
                m = tr.train_epoch(e)
                float(m["loss"])
                ms.append(1e3 * (time.perf_counter() - t0))
                states.append((
                    {k: torch.as_tensor(v).cpu() for k, v in m.items()},
                    {k: (p.grad.cpu(), p.detach().cpu())
                     for k, p in tr.model.named_parameters()}))
            n_ops, busy = device_ops(
                lambda: float(tr.train_epoch(TRAIN_GRAPH_EPOCHS)["loss"]))
            runs[side] = dict(ms=ms, states=states, ops=n_ops, busy=busy,
                              peak=torch.cuda.max_memory_allocated())
            del tr
        finally:
            loop.rollout = orig
    for e, (got, want) in enumerate(zip(runs["graph"]["states"],
                                        runs["eager"]["states"])):
        for k in want[0]:
            if not torch.equal(got[0][k], want[0][k]):
                raise AssertionError(f"graph {case}: epoch {e} {k} differs "
                                     f"from the eager epoch's")
        for k, (g, p) in want[1].items():
            if not (torch.equal(got[1][k][0], g)
                    and torch.equal(got[1][k][1], p)):
                raise AssertionError(f"graph {case}: epoch {e} {k}'s "
                                     f"gradient or value differs")
    eager_med = statistics.median(runs["eager"]["ms"][1:])
    graph_med = statistics.median(runs["graph"]["ms"][1:])
    out = dict(
        B=B, n_query=n_query, T=T_STEPS, attention=attention, mask="data",
        eager_ms=runs["eager"]["ms"], graph_ms=runs["graph"]["ms"],
        eager_ms_median=eager_med, graph_ms_median=graph_med,
        first_graph_epoch_ms=runs["graph"]["ms"][0],
        device_ops_eager=runs["eager"]["ops"],
        device_ops_replay=runs["graph"]["ops"],
        device_busy_ms_eager=runs["eager"]["busy"],
        device_busy_ms_replay=runs["graph"]["busy"],
        peak_bytes_eager=runs["eager"]["peak"],
        peak_bytes_graph=runs["graph"]["peak"])
    log("graph", f"{case} B={B} n_query={n_query} T={T_STEPS} {attention}: "
        f"epoch eager {eager_med:.1f} ms, graph {graph_med:.1f} ms (median "
        f"of {TRAIN_GRAPH_EPOCHS - 1}, host clock to the loss), first "
        f"graphed epoch {runs['graph']['ms'][0]:.1f} ms (eager + capture); "
        f"profiler: {runs['eager']['ops']} device ops an eager epoch "
        f"({runs['eager']['busy']:.1f} ms busy), {runs['graph']['ops']} a "
        f"replayed one ({runs['graph']['busy']:.1f} ms busy); peak "
        f"{runs['eager']['peak'] / 1e9:.2f} GB eager, "
        f"{runs['graph']['peak'] / 1e9:.2f} GB graphed; every epoch's "
        f"losses, gradients and parameters bitwise eager ({smi})")
    return out


def _rank_phases(rank, world, phases, inputs):
    """One rank's part of ``phases``: {phase: record}."""
    res = {}
    if "dp" in phases:
        res["dp"] = _rank_dp(rank, inputs["dp"])
    if "mesh" in phases:
        res["mesh"] = _rank_mesh(rank, inputs["mesh"])
    if "seq" in phases:
        res["seq"] = _rank_seq(rank, inputs["seq"])
    return res


def run_ranks(phases, inputs, world=DIST_WORLD, backend="gloo"):
    """Every rank's result of ``phases`` ({rank: {phase: record}}, arrays
    as tensors): gloo ranks on cuda:0, or NCCL ranks one card each.  Any
    rank's failure, or silence past DIST_TIMEOUT_S, fails the call."""
    from aline_tpu_torch.parallel.mesh import map_leaves
    from aline_tpu_torch.parallel.spawn import run_ranks as spawn_ranks
    t0 = time.perf_counter()
    results = spawn_ranks(_rank_phases, world, phases, inputs,
                          device="cuda:0" if backend == "gloo" else "cuda",
                          backend=backend, timeout=DIST_TIMEOUT_S)
    log("ranks", f"{world} {backend} ranks ({', '.join(phases)}): "
        f"{time.perf_counter() - t0:.1f} s, process start included")
    return dict(enumerate(map_leaves(torch.as_tensor, results)))


def _np_batch(batch):
    """A batch's tensors as numpy (picklable for the ranks)."""
    import dataclasses
    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(batch)
            for v in [getattr(batch, f.name)]}


def _from_np(d, device="cuda"):
    from aline_tpu_torch.tasks.base import Batch
    return Batch(**{k: (torch.from_numpy(v).to(device)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in d.items()})


def _dp_model(cfg):
    """A fresh model from the run's seed, as ``Trainer`` builds it."""
    from aline_tpu_torch.models.aline import build_model
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(cfg.seed)
        return build_model(cfg, "cpu")


def _dp_step_inputs():
    """19: one f32 step's inputs at the recipe (B=200, n_query_init=200,
    T=30; the data mask, Gumbel noise), drawn on the card."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.models.heads import gumbel_noise
    from aline_tpu_torch.ops.target_mask import target_weight_vectors
    from aline_tpu_torch.tasks import build_task, init_ctx_idx
    cfg = parse_overrides(TRAIN_ARGS)
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(19)
    batch = task.sample_batch(gen, cfg.batch_size,
                              n_query=cfg.task.n_query_init)
    mask = torch.arange(batch.n_target, device="cuda") < batch.n_target_data
    batch = init_ctx_idx(batch.replace(target_mask=mask),
                         task.n_context_init + DP_T)
    w_q, w_p = target_weight_vectors(mask.cpu().numpy(), "mix", "split",
                                     task.n_target_data, task.n_target_theta)
    noise = gumbel_noise((DP_T, batch.batch_size, batch.n_points), gen)
    return dict(batch=_np_batch(batch), w_q=w_q, w_p=w_p,
                noise=noise.cpu().numpy(),
                sel=tuple(range(task.n_target_data)))


def _dp_step(inp, group=None, n_ranks=1, rows=slice(None), extra=()):
    """One main-phase ``train_step`` on the card from the seed's model,
    in float32 unless ``extra`` says otherwise: (metrics, grads, params)
    on the CPU."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.train.loop import ROW_FIELDS, train_step
    from aline_tpu_torch.train.optimizer import build_optimizer
    cfg = parse_overrides(TRAIN_ARGS + list(extra))
    model = _dp_model(cfg).to("cuda").train()
    batch = _from_np(inp["batch"])
    batch = batch.replace(**{f: getattr(batch, f)[rows] for f in ROW_FIELDS})
    noise = torch.from_numpy(inp["noise"][:, rows].copy()).cuda()
    opt, sched = build_optimizer(cfg, model, "main")
    m = train_step(model, opt, sched, batch, DP_T,
                   torch.from_numpy(inp["w_q"]).cuda(),
                   torch.from_numpy(inp["w_p"]).cuda(), cfg.alpha, noise,
                   gamma=cfg.gamma, sel_targets=inp["sel"],
                   remat_policy=cfg.remat_policy, group=group,
                   n_ranks=n_ranks)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def _grads_within(label, got, ref, rel, own=0.0):
    """Max |got - ref| over every gradient, as a share of ref's largest
    element; raises where an element is off by more than ``rel`` of that
    largest plus ``own`` of itself (phase 7's rule: both TOL)."""
    scale = max(g.abs().max().item() for g in ref.values())
    worst = 0.0
    for n, g in ref.items():
        err = (got[n] - g).abs()
        worst = max(worst, err.max().item() / scale)
        if not bool((err <= own * g.abs() + rel * scale).all()):
            raise AssertionError(f"{label}: grad of {n} off by "
                                 f"{err.max():.3e} (largest grad "
                                 f"{scale:.3e})")
    return worst


def _rank_dp(rank, inp):
    """19b on this rank: the 2-rank f32 step and bf16 step (every kernel),
    3 f32 epochs of the trainer (its parameters), then 2 burning and 2
    main bf16 epochs with every kernel (ms, launches, peak memory).  Rank
    2 takes no part."""
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.parallel.mesh import get_mesh
    from aline_tpu_torch.train.loop import Trainer
    import torch.distributed as dist
    mesh = get_mesh(2)
    device = f"cuda:{torch.cuda.current_device()}"
    rec = {"device": device, "backend": dist.get_backend()}
    if mesh.member:
        m = inp["batch"]["x"].shape[0] // 2
        rows = slice(rank * m, (rank + 1) * m)
        metrics, grads, _ = _dp_step(inp, mesh.group("data"), 2, rows)
        rec["step"] = dict(metrics=metrics, grads=grads)
        metrics, grads, _ = _dp_step(inp, mesh.group("data"), 2, rows,
                                     extra=DP_BF16_STEP)
        rec["bf16_step"] = dict(metrics=metrics, grads=grads)
    for tag, extra in (("f32", ["max_epoch=3", "mesh_data=2"]),
                       ("bf16", DP_BF16_ARGS)):
        out = Path(inp["out_dir"]) / f"dp_{tag}"
        cfg = parse_overrides(TRAIN_ARGS + extra + [f"output_dir={out}"])
        tr = Trainer(cfg, device=device)
        if not tr.active:
            rec[tag] = "took no part"
            continue
        tr._ensure_phase("burning")
        epochs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for epoch in range(cfg.max_epoch):
            reset_launches()
            t0 = time.perf_counter()
            mm = {k: float(v) for k, v in tr.train_epoch(epoch).items()}
            epochs.append(dict(epoch=epoch, phase=tr.phase, ms=1e3 * (
                time.perf_counter() - t0), launches=launches(), **mm))
        rec[tag] = dict(epochs=epochs,
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        params={n: p.detach().cpu() for n, p in
                                tr.model.named_parameters()},
                        n_data=tr.n_data)
    return rec


def phase_dp(smi):
    """19: data-parallel training at bench.py's recipe through ``Trainer``
    with ``mesh_data``: (a) one rank under NCCL; (b) two gloo ranks that
    share cuda:0; (c) NCCL, one card a rank, where there are two cards.
    Returns the record and the inputs the ranks need."""
    import tempfile
    import torch.distributed as dist
    inp = _dp_step_inputs()
    inp["out_dir"] = str(OUT_DIR / "dp_smoke")
    ref_m, ref_g, _ = _dp_step(inp)
    ref_bf16 = _dp_step(inp, extra=DP_BF16_STEP)[:2]
    # (a) world size 1 under NCCL: the collectives on the step's path
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    try:
        m1, g1, _ = _dp_step(inp, dist.group.WORLD, 1)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    worst_a = _grads_within("dp (a)", g1, ref_g, 1e-6)
    log("dp", f"(a) world size 1, backend nccl, rank 0 on cuda:0: one f32 "
        f"step (B=200, T={DP_T}) through the all-reduces, loss "
        f"{m1['loss']:.6f} vs {ref_m['loss']:.6f} undistributed, grads "
        f"within {worst_a:.3e} of the largest (limit 1e-6)")
    rec = dict(a=dict(loss=m1["loss"], ref_loss=ref_m["loss"],
                      grads_rel=worst_a))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # (c): (b) again under NCCL, one card a rank
        ranks = run_ranks(["dp"], {"dp": inp}, world=2, backend="nccl")
        rec["c"] = _check_dp_ranks("(c) nccl", ranks, ref_g, ref_bf16)
    else:
        rec["c"] = f"not run: {n_cards} CUDA device visible"
        log("dp", f"(c) NCCL, one card a rank: not run, {n_cards} CUDA "
            f"device visible (NCCL cannot put two ranks on one card)")
    return rec, inp, (ref_g, ref_bf16)


def _check_dp_ranks(label, ranks, ref_g, ref_bf16):
    """Ranks 0 and 1: the f32 step's grads against the one-process step
    (phase 7's rule) and equal on both, the bf16 step's losses and grads
    against the one-process bf16 step (phase 7c's limits), the parameters
    bitwise equal after 3 f32 epochs: (the worst f32 gradient gap, the
    worst bf16 relative L2 gap)."""
    from aline_tpu_torch.config import parse_overrides
    r0, r1 = ranks[0]["dp"], ranks[1]["dp"]
    worst = max(_grads_within(f"dp {label} rank {r}", ranks[r]["dp"]
                              ["step"]["grads"], ref_g, TOL, TOL)
                for r in (0, 1))
    for n, g in r0["step"]["grads"].items():
        if not torch.equal(g, r1["step"]["grads"][n]):
            raise AssertionError(f"dp {label}: ranks hold other grads of "
                                 f"{n}")
    cfg = parse_overrides(TRAIN_ARGS + DP_BF16_STEP)
    model = _dp_model(cfg)
    ref_m, ref_bg = ref_bf16
    worst_bf16 = max(
        bf16_step_parity(f"dp {label} rank {r}", cfg, model, ref_m,
                         step["metrics"], ref_bg, step["grads"],
                         what=f"B=200 T={DP_T} over 2 ranks",
                         sides=("one process", f"rank {r}"))
        for r in (0, 1) for step in [ranks[r]["dp"]["bf16_step"]])
    for n, p in r0["f32"]["params"].items():
        if not torch.equal(p, r1["f32"]["params"][n]):
            raise AssertionError(f"dp {label}: {n} differs between the "
                                 f"ranks after 3 epochs")
    log("dp", f"{label}: ranks 0 ({r0['backend']}, {r0['device']}) and 1 "
        f"({r1['backend']}, {r1['device']}): one f32 step on 100 rows each,"
        f" all-reduced grads within {worst:.3e} of the largest of the "
        f"one-process step (limit {TOL} + {TOL} of each element), equal on"
        f" both ranks; one bf16 step (flash, fused_gmm=on) within "
        f"{worst_bf16:.3e} relative L2 of the one-process step's grads "
        f"(limit {BF16_GRAD_RTOL}); parameters bitwise equal on both after "
        f"3 epochs (2 burning, 1 main; f32)")
    return worst, worst_bf16


def check_dp(smi, rec, ranks, refs):
    """19b: the ranks' steps against the one-process steps (phase 7's
    tolerance in f32, 7c's in bf16), their parameters bitwise equal after
    3 epochs, the bf16
    epochs' launches (60 GMM forwards, 30 backwards, 60 plans, 180 and 90
    bf16 flash calls a main epoch, each rank) and times."""
    from aline_tpu_torch.config import parse_overrides
    r0, r1 = ranks[0]["dp"], ranks[1]["dp"]
    worst, worst_bf16 = _check_dp_ranks("(b) gloo", ranks, *refs)
    if ranks[2]["dp"]["f32"] != "took no part":
        raise AssertionError("dp: rank 2 trained beyond mesh_data=2")
    log("dp", f"(b) rank 2 ({ranks[2]['dp']['backend']}, "
        f"{ranks[2]['dp']['device']}) took no part (mesh_data=2 of 3 ranks)")
    cfg = parse_overrides(TRAIN_ARGS + DP_BF16_ARGS)
    out = {}
    for r, rr in ((0, r0), (1, r1)):
        b = rr["bf16"]
        for e in b["epochs"]:
            fwd = e["T"] * 2
            want = expected_launches(
                cfg, gmm_head_fwd=fwd, gmm_head_bwd=e["T"], flash_plan=fwd,
                flash_attn_fwd=cfg.encoder.num_layers * fwd,
                flash_attn_bwd=cfg.encoder.num_layers * e["T"])
            if e["launches"] != want:
                raise AssertionError(f"dp rank {r} epoch {e['epoch']}: "
                                     f"launches {e['launches']}, expected "
                                     f"{want}")
            if not math.isfinite(e["loss"]):
                raise AssertionError(f"dp rank {r}: loss {e['loss']}")
        warm = [e["ms"] for e in b["epochs"] if e["phase"] == "main"][1:]
        out[r] = dict(warm_ms=statistics.median(warm),
                      peak_bytes=b["peak_bytes"], epochs=[
                          {k: v for k, v in e.items()} for e in b["epochs"]])
        log("dp", f"(b) rank {r}, backend {rr['backend']}, {rr['device']}, "
            f"bf16 + flash + "
            f"fused_gmm=on, B=200 over 2 ranks: warm main epoch "
            f"{out[r]['warm_ms']:.1f} ms, peak memory "
            f"{b['peak_bytes'] / 2**30:.3f} GiB, launches a main epoch "
            f"{b['epochs'][-1]['launches']} ({smi})")
    for n, p in r0["bf16"]["params"].items():
        if not torch.equal(p, r1["bf16"]["params"][n]):
            raise AssertionError(f"dp (b): bf16 {n} differs between ranks")
    totals = {k: sum(e["launches"][k] for rr in (r0, r1)
                     for e in rr["bf16"]["epochs"]) for k in launches()}
    rec["b"] = dict(step_grads_rel=worst, bf16_step_grads_rel_l2=worst_bf16,
                    ranks=out)
    rec["launches"] = totals
    return rec


def _mesh_inputs():
    """20: one batch of loc_100k at the full protocol (B=200,
    n_query=2000, T=34, bf16 traces) and its single-process bounds."""
    from aline_tpu_torch.eval.eig import compute_eig_from_history
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)
    cfg, model = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cuda")
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(20)
    batch = task.sample_batch(gen, BED["batch_size"], n_query=BED["n_query"])
    theta0, x, y = get_traces(model, task, batch, BED["T"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pce, nmc = compute_eig_from_history(task, theta0, x, y, BED["L"], 20,
                                        stepwise=True)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    return dict(theta0=theta0.cpu().numpy(), x=x.cpu().numpy(),
                y=y.cpu().numpy(), pce=pce.cpu(), nmc=nmc.cpu(),
                single_s=single_s)


MESHES = (("1d", 2), ("2d", (2, 1)), ("2d", (1, 2)))


def _rank_mesh(rank, inp):
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.eval.eig import compute_eig_from_history
    from aline_tpu_torch.ops import _build
    from aline_tpu_torch.parallel.mesh import get_eval_mesh, get_mesh
    from aline_tpu_torch.tasks import build_task
    task = build_task(parse_overrides(["task=location_finding"]).task)
    args = [torch.from_numpy(inp[k]).cuda() for k in ("theta0", "x", "y")]
    res = {}
    for kind, shape in MESHES:
        mesh = (get_mesh(shape, "contrastive") if kind == "1d"
                else get_eval_mesh(*shape))
        if not mesh.member:
            continue
        torch.cuda.synchronize()
        before = _build.LAUNCHES["loc_eig_fold"]
        t0 = time.perf_counter()
        pce, nmc = compute_eig_from_history(task, *args, BED["L"], 20,
                                            stepwise=True, mesh=mesh)
        torch.cuda.synchronize()
        res[(kind, shape)] = dict(
            s=time.perf_counter() - t0, pce=pce.cpu(), nmc=nmc.cpu(),
            folds=_build.LAUNCHES["loc_eig_fold"] - before,
            n_data=mesh.axis_size("data"))
    return res


def check_mesh(smi, inp, ranks):
    """The ranks' bounds against the single process's; the contrastive
    ranks split the chunks, each data rank folds its block on its rows:
    n_chunks × (data ranks) fold launches over the ranks of a mesh."""
    from aline_tpu_torch.eval.eig import chunk_size
    B, Th = BED["batch_size"], BED["T"] + 1
    n_chunks = math.ceil(BED["L"] / chunk_size(BED["L"], B, Th, 32_768))
    rec = dict(single_s=inp["single_s"], meshes={})
    folds = 0
    for kind, shape in MESHES:
        per = {}
        # (the ranks' numbers come back as tensors)
        by_rank = [int(ranks[r]["mesh"][(kind, shape)]["folds"])
                   for r in range(2)]
        want = n_chunks * int(ranks[0]["mesh"][(kind, shape)]["n_data"])
        if sum(by_rank) != want:
            raise AssertionError(f"mesh {kind} {shape}: fold launches "
                                 f"{by_rank} by rank, expected {want} in "
                                 f"all")
        per["fold_launches"] = by_rank
        folds += want
        for r in range(2):
            got = ranks[r]["mesh"][(kind, shape)]
            for name in ("pce", "nmc"):
                err = (got[name] - inp[name]).abs().max().item()
                if err > 1e-5:
                    raise AssertionError(f"mesh {kind} {shape} rank {r}: "
                                         f"{name} off by {err:.3e}")
                per.setdefault("max_abs", 0.0)
                per["max_abs"] = max(per["max_abs"], err)
            per[f"rank{r}_s"] = got["s"]
        rec["meshes"][f"{kind} {shape}"] = per
        log("mesh", f"{kind} mesh {shape}, backend gloo, ranks 0, 1 on "
            f"cuda:0: loc_100k B={BED['batch_size']} Th={BED['T'] + 1} "
            f"L={BED['L']:.0e} per-step bounds within {per['max_abs']:.3e} "
            f"of the single process (limit 1e-5); the fold "
            f"{per['rank0_s']:.3f} s on rank 0, {per['rank1_s']:.3f} s on "
            f"rank 1, {inp['single_s']:.3f} s alone ({smi})")
    for r in (2,):
        if ranks[r]["mesh"]:
            raise AssertionError("mesh: rank 2 folded outside the meshes")
    rec["launches"] = {k: 0 for k in launches()}
    rec["launches"]["loc_eig_fold"] = folds
    return rec


def _seq_inputs():
    """21 and 21b: a loc_100k batch with the full 2001-token pool, and the
    unsharded greedy rollouts' choices on the card (bf16): compact (21),
    then flash (21b) with its launches, and flash in float32 on the first
    SEQ_F32_ROWS rows."""
    from aline_tpu_torch.tasks import build_task, init_ctx_idx
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)
    cfg, model = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cuda")
    task = build_task(cfg.task)
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = task.sample_batch(gen, BED["batch_size"], n_query=BED["n_query"])
    b = init_ctx_idx(batch, task.n_context_init + BED["T"])
    rec = dict(batch=_np_batch(b))
    ro, rec["unsharded_s"], _ = _seq_rollout(model, b)
    rec["idx"] = ro.idx.cpu()
    flash = {"flash": run_copy("seq_flash_run", attention_impl="flash",
                               src=LOC_RUN),
             "flash_f32": run_copy("seq_flash_f32_run", dtype="float32",
                                   attention_impl="flash", src=LOC_RUN)}
    rec["flash_runs"] = flash
    _, fmodel = load_model(flash["flash"], LOC_100K_PARAMS, "cuda")
    _seq_rollout(fmodel, b, T=1)                 # the kernels loaded
    ro, rec["flash_s"], rec["flash_launches"] = _seq_rollout(fmodel, b)
    rec["flash_idx"], rec["flash_lp"] = ro.idx.cpu(), ro.log_probs.cpu()
    _, f32 = load_model(flash["flash_f32"], LOC_100K_PARAMS, "cuda")
    ro = _seq_rollout(f32, batch_rows(b, SEQ_F32_ROWS, "cuda"))[0]
    rec["f32_idx"], rec["f32_lp"] = ro.idx.cpu(), ro.log_probs.cpu()
    return rec


def _seq_rollout(model, b, T=BED["T"]):
    """(the unsharded greedy rollout of ``b``, its wall seconds, its
    launches)."""
    from aline_tpu_torch.train.rollout import rollout
    zero = torch.zeros(b.n_target, device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ro = rollout(model, b, T, zero, zero, None, time_forward=False,
                     use_remat=False)
    torch.cuda.synchronize()
    return ro, time.perf_counter() - t0, launches()


def _sharded_rollout(model, batch, mesh, T=BED["T"]):
    """(idx, log-probs, wall seconds, launches) of ``sharded_greedy_rollout``
    on this rank."""
    from aline_tpu_torch.eval.traces import sharded_greedy_rollout
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        idx, _, _, lp = sharded_greedy_rollout(model, batch, T, False, mesh)
    torch.cuda.synchronize()
    return idx.cpu(), lp.cpu(), time.perf_counter() - t0, launches()


def _rank_seq(rank, inp):
    from aline_tpu_torch.parallel.mesh import get_mesh
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)
    _, model = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cuda")
    mesh = get_mesh(SEQ_RANKS, "seq")
    batch = _from_np(inp["batch"])
    idx, _, s, counts = _sharded_rollout(model, batch, mesh)
    rec = dict(idx=idx, s=s, launches=counts)
    # 21b: flash, bf16 (the kernels loaded by one step first), then float32
    _, fmodel = load_model(inp["flash_runs"]["flash"], LOC_100K_PARAMS,
                           "cuda")
    _sharded_rollout(fmodel, batch, mesh, T=1)
    idx, lp, s, counts = _sharded_rollout(fmodel, batch, mesh)
    rec["flash"] = dict(idx=idx, lp=lp, s=s, launches=counts)
    _, f32 = load_model(inp["flash_runs"]["flash_f32"], LOC_100K_PARAMS,
                        "cuda")
    idx, lp = _sharded_rollout(f32, batch_rows(batch, SEQ_F32_ROWS, "cuda"),
                               mesh)[:2]
    rec["flash_f32"] = dict(idx=idx, lp=lp)
    return rec


def seq_ties(tag, model, batch_np, ref, got):
    """The rows where ``got`` [T, B] leaves the unsharded choices ``ref``,
    and the largest bf16-ulp gap between the unsharded design scores of
    the two candidates at such a row's first change (phase 4c's rule:
    at most BF16_TIE_ULPS)."""
    from aline_tpu_torch.tasks.base import select_design
    differs, first = first_change(got.T, ref.T)
    gap = torch.zeros(ref.shape[1], dtype=torch.int32)
    if differs.any():
        b = _from_np(batch_np)
        with torch.no_grad():
            for t in range(int(first[differs].max()) + 1):
                _, sc = design_forward(model, b)
                here = differs & (first == t)
                g = score_gap_ulps(sc.cpu(), ref[t], got[t])
                gap = torch.where(here, g, gap)
                b, _, _ = select_design(b, ref[t].cuda())
    worst = int(gap[differs].max()) if differs.any() else 0
    if worst > BF16_TIE_ULPS:
        raise AssertionError(f"{tag}: a row leaves the unsharded choices at "
                             f"a score gap of {worst} bf16 ulps")
    return differs, worst


def check_seq(smi, inp, ranks):
    """21: every rank's choices equal the unsharded ones, or a row leaves
    them where the unsharded bf16 design scores of the two candidates lie
    within BF16_TIE_ULPS (phase 4c's rule)."""
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)
    _, model = load_model(str(LOC_RUN), LOC_100K_PARAMS, "cuda")
    ref = inp["idx"]                                     # [T, B]
    for r in range(1, SEQ_RANKS):
        if not torch.equal(ranks[r]["seq"]["idx"], ranks[0]["seq"]["idx"]):
            raise AssertionError(f"seq: rank {r} chose otherwise than 0")
    differs, worst = seq_ties("seq", model, inp["batch"], ref,
                              ranks[0]["seq"]["idx"])
    if any(any(ranks[r]["seq"]["launches"].values())
           for r in range(SEQ_RANKS)):
        raise AssertionError("seq: a kernel was launched (compact path)")
    times = [ranks[r]["seq"]["s"] for r in range(SEQ_RANKS)]
    log("seq", f"loc_100k greedy traces, B={BED['batch_size']}, pool 2001 "
        f"over {SEQ_RANKS} ranks (backend gloo, all on cuda:0), T="
        f"{BED['T']}, bf16: {int(differs.sum())} of {ref.shape[1]} rows "
        f"leave the unsharded choices, at gaps up to {worst} ulps (limit "
        f"{BF16_TIE_ULPS}); rollout wall {max(times):.2f} s sharded (ranks "
        f"{', '.join(f'{t:.2f}' for t in times)}), {inp['unsharded_s']:.2f}"
        f" s unsharded ({smi})")
    return dict(rows_differing=int(differs.sum()), max_tie_gap_ulps=worst,
                sharded_s=times, unsharded_s=inp["unsharded_s"],
                launches={k: 0 for k in launches()})


def check_seq_flash(smi, inp, ranks):
    """21b: the same traces with attention_impl=flash in bf16: every rank's
    choices equal rank 0's, and the unsharded flash choices but at ties
    (``seq_ties``); each rank launched exactly T plans and T x layers bf16
    flash forwards, as the unsharded rollout did, and nothing else.  The
    float32 control on SEQ_F32_ROWS rows is reported, not held: the rows
    that leave the unsharded choices, and whether the log-probs came out
    bitwise equal."""
    from aline_tpu_torch.utils.serialization import (
        LOC_100K_PARAMS, load_model)
    cfg, model = load_model(inp["flash_runs"]["flash"], LOC_100K_PARAMS,
                            "cuda")
    per = [ranks[r]["seq"]["flash"] for r in range(SEQ_RANKS)]
    f32 = [ranks[r]["seq"]["flash_f32"] for r in range(SEQ_RANKS)]
    for r in range(1, SEQ_RANKS):
        if not (torch.equal(per[r]["idx"], per[0]["idx"])
                and torch.equal(f32[r]["idx"], f32[0]["idx"])):
            raise AssertionError(f"seq flash: rank {r} chose otherwise "
                                 f"than 0")
    differs, worst = seq_ties("seq flash", model, inp["batch"],
                              inp["flash_idx"], per[0]["idx"])
    want = expected_launches(cfg, flash_plan=BED["T"],
                             flash_attn_fwd=BED["T"] * cfg.encoder.num_layers)
    for who, counts in [("unsharded", inp["flash_launches"])] + [
            (f"rank {r}", per[r]["launches"]) for r in range(SEQ_RANKS)]:
        if counts != want:
            raise AssertionError(f"seq flash: {who} launched {counts}, "
                                 f"expected {want}")
    same = ~differs
    lp_err = (per[0]["lp"] - inp["flash_lp"])[:, same].abs().max().item()
    f32_differs = first_change(f32[0]["idx"].T, inp["f32_idx"].T)[0]
    f32_err = (f32[0]["lp"] - inp["f32_lp"])[:, ~f32_differs].abs().max()
    f32_err = f32_err.item()
    f32_bitwise = bool(torch.equal(f32[0]["lp"], inp["f32_lp"]))
    times = [p["s"] for p in per]
    log("seq", f"21b: the same traces under attention_impl=flash, bf16, "
        f"over {SEQ_RANKS} ranks (gloo, cuda:0): {int(differs.sum())} of "
        f"{differs.numel()} rows leave the unsharded flash choices, at gaps "
        f"up to {worst} ulps (limit {BF16_TIE_ULPS}); the other rows' "
        f"log-probs within {lp_err:.3e}; launches per rank "
        f"{per[0]['launches']}; rollout wall {max(times):.2f} s sharded "
        f"(ranks {', '.join(f'{t:.2f}' for t in times)}), "
        f"{inp['flash_s']:.2f} s unsharded; float32 on {SEQ_F32_ROWS} "
        f"rows: {int(f32_differs.sum())} rows leave the unsharded choices; "
        f"the log-probs of the others "
        f"{'bitwise equal' if f32_bitwise else f'within {f32_err:.3e}'} "
        f"({smi})")
    return dict(rows_differing=int(differs.sum()), max_tie_gap_ulps=worst,
                lp_max_abs=lp_err, f32_rows_differing=int(f32_differs.sum()),
                f32_lp_max_abs=f32_err, f32_lp_bitwise=f32_bitwise,
                sharded_s=times,
                unsharded_s=inp["flash_s"],
                launches_per_rank=[p["launches"] for p in per],
                launches={k: sum(p["launches"][k] for p in per)
                          for k in launches()})


def _settings_step(label, extra):
    """One f32 step of the recipe with ``full`` and with ``dots`` from the
    same model and inputs, each run twice (the second timed): (worst
    gradient gap relative to the largest, {policy: (peak bytes above
    the start, seconds)}, the dots step's launches)."""
    inp = _dp_step_inputs()
    out = {}
    for policy in ("full", "dots"):
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            _, g, _ = _dp_step(inp, extra=list(extra)
                               + [f"remat_policy={policy}"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out[policy] = (g, torch.cuda.max_memory_allocated() - base,
                           seconds, launches())
    worst = _grads_within(f"{label} dots", out["dots"][0], out["full"][0],
                          TOL, TOL)
    return (worst, {p: out[p][1:3] for p in out}, out["dots"][3])


def phase_settings(smi):
    """The trainer's settings on the card: ``remat_policy=dots`` against
    ``full`` (fused_gmm=on, and flash); a 3-epoch run with
    ``profile_dir`` in a temporary directory; one epoch with
    ``debug_nans=true``."""
    import tempfile
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.train.loop import Trainer
    rec, paths = {}, {}
    for label, extra in (("fused_gmm=on", ["head.fused_gmm=on"]),
                         ("flash", ["head.fused_gmm=on",
                                    "encoder.attention_impl=flash"])):
        worst, by, counts = _settings_step(label, extra)
        rec[label] = dict(grads_rel=worst, full_peak=by["full"][0],
                          dots_peak=by["dots"][0], full_s=by["full"][1],
                          dots_s=by["dots"][1])
        paths[f"dots_{label.split('=')[0]}"] = counts
        log("settings", f"remat_policy=dots vs full, {label}, one f32 step "
            f"B=200 n_query_init=200 T={DP_T}: grads within {worst:.3e} of "
            f"the largest (limit {TOL}); step peak memory above the start "
            f"{by['dots'][0] / 2**30:.3f} GiB dots, "
            f"{by['full'][0] / 2**30:.3f} GiB full; the step (model built "
            f"from the seed included) {by['dots'][1] * 1e3:.1f} ms dots, "
            f"{by['full'][1] * 1e3:.1f} ms full; dots launches {counts} "
            f"({smi})")
    prof = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        cfg = parse_overrides(TRAIN_ARGS + [
            "max_epoch=3", f"profile_dir={prof}",
            f"output_dir={OUT_DIR / 'profile_smoke'}"])
        Trainer(cfg, device="cuda").train()
        trace = Path(prof) / "trace_rank0.json"
        text = trace.read_text()
        rec["profile"] = dict(bytes=trace.stat().st_size,
                              names_gmm_head_fwd="gmm_head_fwd" in text,
                              epochs=sorted(set(
                                  w for w in ("epoch_1", "epoch_2")
                                  if f'"{w}"' in text)))
    finally:
        shutil.rmtree(prof, ignore_errors=True)
    if not rec["profile"]["names_gmm_head_fwd"] \
            or rec["profile"]["epochs"] != ["epoch_2"]:
        raise AssertionError(f"profile_dir: {rec['profile']}")
    log("settings", f"profile_dir, 3 epochs: trace of epoch 2, "
        f"{rec['profile']['bytes'] / 2**20:.1f} MiB, names gmm_head_fwd")
    cfg = parse_overrides(TRAIN_ARGS + [
        "max_epoch=1", "debug_nans=true",
        f"output_dir={OUT_DIR / 'nan_smoke'}"])
    t0 = time.perf_counter()
    Trainer(cfg, device="cuda").train()
    rec["debug_nans_s"] = time.perf_counter() - t0
    log("settings", f"debug_nans=true: one epoch (B=200, T=30) raised "
        f"nothing, {rec['debug_nans_s']:.1f} s")
    return rec, paths


def dist_phases(smi, only):
    """Phases 19-21 (those in ``only``) and, with dp, the settings:
    {name: record}."""
    rec, inputs, refs = {}, {}, {}
    if "dp" in only:
        rec["dp"], inputs["dp"], refs["dp"] = phase_dp(smi)
    if "mesh" in only:
        inputs["mesh"] = _mesh_inputs()
    if "seq" in only:
        inputs["seq"] = _seq_inputs()
    phases = [p for p in ("dp", "mesh", "seq") if p in only]
    # the ranks take the inputs, not the one-process results
    refs_only = ("pce", "nmc", "idx", "flash_idx", "flash_lp", "f32_idx",
                 "f32_lp")
    ranks = run_ranks(phases, {k: {kk: vv for kk, vv in v.items()
                                   if kk not in refs_only}
                               for k, v in inputs.items()})
    if "dp" in only:
        rec["dp"] = check_dp(smi, rec["dp"], ranks, refs["dp"])
        rec["settings"], rec["settings_paths"] = phase_settings(smi)
    if "mesh" in only:
        rec["mesh"] = check_mesh(smi, inputs["mesh"], ranks)
    if "seq" in only:
        rec["seq"] = check_seq(smi, inputs["seq"], ranks)
        rec["seq_flash"] = check_seq_flash(smi, inputs["seq"], ranks)
    return rec


NEW_PHASES = ("ces", "psych", "hpo", "train_tasks", "gp", "bench", "cont",
              "dad", "trend", "demo", "demo_train", "hpob", "graph")
DIST_PHASES = ("dp", "mesh", "seq")
LOC_PHASES = ("bed", "train_loc")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke run of the port on one NVIDIA GPU; with no "
                    "arguments, every phase")
    ap.add_argument("--only", nargs="+",
                    choices=("kernels", "fold", "wide", "wide_kernels")
                    + LOC_PHASES + NEW_PHASES + DIST_PHASES,
                    help="run only these of phases 8-25 (after phase 1) "
                         "and print no kernels line; kernels: phases 2-3e "
                         "and the kernels line; fold: phase 3e and its "
                         "row of it")
    ap.add_argument("--ces-M", type=int, default=CES_SMOKE_M,
                    help="phase 10's rows (2000: the JAX run's protocol)")
    return ap.parse_args(argv)


def new_phases(smi, only, ces_M, gp_B):
    """Phases 10-18 and 22-25 (those named in ``only``), phase 14 with
    ``gp_B`` problems: {name: record}."""
    rec = {}
    if "ces" in only:
        rec["ces_bed"] = timed("ces_bed", phase_ces_bed, smi, ces_M)
        rec["ces_witness"] = timed("ces_witness", phase_ces_witness)
    if "psych" in only:
        rec["psychometric"] = timed("psychometric", phase_psych, smi)
    if "hpo" in only:
        rec["hpo"] = timed("hpo", phase_hpo, smi)
    if "train_tasks" in only:
        rec["train_tasks"] = timed("train_tasks", phase_train_tasks, smi)
    if "bench" in only:
        rec["bench"] = timed("bench", phase_bench, smi)
    if "cont" in only:
        rec["cont"] = timed("cont", phase_cont, smi)
    if "dad" in only:
        rec["dad"] = timed("dad", phase_dad, smi)
    if "trend" in only:
        rec["trend"] = timed("trend", phase_trend, smi)
    if "gp" in only:
        rec["gp"] = timed("gp", phase_gp, smi, gp_B)
    if "demo" in only:
        rec["demo_eval"] = timed("demo_eval", phase_demo_eval, smi)
    if "demo_train" in only:
        rec["demo_train"] = timed("demo_train", phase_demo_train, smi)
    if "hpob" in only:
        rec["hpob"] = timed("hpob", phase_hpob, smi)
    if "graph" in only:
        rec["graph"] = timed("graph", phase_graph, smi)
    return rec


# Phase wide (b), (c): al1d_wide128 (``aline_tpu_torch.config.
# WIDE128_RECIPE``, assets/al1d_wide128_config.json) trained from the
# seed's init through train's main, then evaluated through eval_al's main
# on that run's weights; the runs live in a temporary directory (a model
# of 90M parameters: 360 MB an npz).  Cut to the script's time limit, no
# width cut: training to WIDE_TRAIN_CUT (1 burning and 2 main epochs, the
# recipe's B=200 cut to 50: an f32 epoch at B=200 takes about 21 s on an
# H100, and the bf16 one as long, its Dense products summed in float32 as
# flax rounds them); the eval at the flagship's protocol (B=100, n_query=2000,
# T=30, three strategies) in bf16, and in f32 at WIDE_F32_EVAL_B rows.
# The no-kernel path (compact attention, fused_gmm=off) builds
# [B, T, C, F] in the head (32.8 GB at B=100 in f32), so it is held to
# the kernel path on the first WIDE_HOLD_B rows of the same batch.
WIDE_TRAIN_CUT = ["burning_epoch=1", "max_epoch=3", "checkpoint=0",
                  "verbose=1", "batch_size=50"]
WIDE_F32_EVAL_B = 10
WIDE_HOLD_B = 8
WIDE_PROFILE_T = 1      # the profiled bf16 eval: 3 x 2 forwards, B=100


def phase_wide_train(smi, dtype, work):
    """Phase wide (b): ``train``'s main on WIDE128_RECIPE in ``dtype``,
    its run under ``work``: each epoch's launches as the rollout and its
    backward call the kernels, finite losses, the warm epoch, peak
    memory."""
    from aline_tpu_torch.config import WIDE128_RECIPE
    from aline_tpu_torch.train import __main__ as entry
    from aline_tpu_torch.train.loop import Trainer

    tag = f"wide train {dtype}"
    out_dir = work / f"wide_train_{dtype}"
    epochs = []
    epoch_fn = Trainer.train_epoch

    def counted_epoch(self, epoch):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        m = epoch_fn(self, epoch)
        torch.cuda.synchronize()
        epochs.append(dict(epoch=epoch, phase=self.phase,
                           s=time.perf_counter() - t0, launches=launches(),
                           T=int(m["T"]), loss=float(m["loss"])))
        return m

    undo = patched([(Trainer, "train_epoch", counted_epoch)])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = entry.main(list(WIDE128_RECIPE) + WIDE_TRAIN_CUT
                             + [f"dtype={dtype}", "device=cuda",
                                f"output_dir={out_dir}"])
        peak = torch.cuda.max_memory_allocated()
    finally:
        patched(undo)
    cfg = trainer.cfg
    layers = cfg.encoder.num_layers
    gmm = int(trainer.model.head.target_head.use_kernel(
        trainer.task.n_target_data + trainer.task.n_target_theta))
    totals = {name: 0 for name in launches()}
    for e in epochs:
        fwd = e["T"] * (2 if cfg.rollout_remat else 1)
        want = expected_launches(
            cfg, gmm_head_fwd=gmm * fwd, gmm_head_bwd=gmm * e["T"],
            flash_plan=fwd, flash_attn_fwd=layers * fwd,
            flash_attn_bwd=layers * e["T"])
        if e["launches"] != want:
            raise AssertionError(f"{tag} epoch {e['epoch']}: launches "
                                 f"{e['launches']}, expected {want}")
        if not math.isfinite(e["loss"]):
            raise AssertionError(f"{tag} epoch {e['epoch']}: loss "
                                 f"{e['loss']}")
        for name in totals:
            totals[name] += e["launches"][name]
        log(tag, f"epoch {e['epoch']} ({e['phase']}): {1e3 * e['s']:.1f} "
            f"ms, loss {e['loss']:.4f}, launches "
            f"{ {n: c for n, c in e['launches'].items() if c} }")
    params = Path(trainer.model_path())
    if not params.exists():
        raise AssertionError(f"{tag}: no parameters at {params}")
    warm_ms = 1e3 * statistics.median(
        [e["s"] for e in epochs if e["phase"] == "main"][1:])
    log(tag, f"B={cfg.batch_size} T={cfg.T} d={cfg.encoder.dim_embedding} "
        f"H={cfg.encoder.n_head} F={cfg.encoder.dim_feedforward} "
        f"C={cfg.head.num_components} {cfg.dtype} flash: warm epoch "
        f"{warm_ms:.1f} ms, {cfg.batch_size / warm_ms * 1e3:.2f} rollouts/s,"
        f" peak memory {peak / 2**30:.3f} GiB ({smi})")
    return dict(epochs=epochs, warm_ms=warm_ms, peak_bytes=peak,
                launches=totals, run_dir=str(out_dir), params=str(params))


# Phase wide (b)'s f32 step: a GMM hidden unit (c, f) whose CPU
# pre-activation lies within WIDE_MASK_BAND of the call's largest |pre| of
# 0 for some token has an ill-determined relu mask there.  The card's
# 3xTF32 sums and the CPU's float32 ones differ by ~1e-6 of that scale,
# and a flipped mask moves dh, and with it dW1[c, :, f] and db1[c, f], by
# a whole term.  Summing the head in float64 on the CPU alone moves 69 of
# heads_w1's 41.9M gradient entries past phase 7's limit.
WIDE_MASK_BAND = 1e-5


def phase_wide_step_parity():
    """Phase wide (b): one step of a fresh al1d_wide128 model from the
    seed on the card against one on the CPU, f32 under phase 7's limits
    (but the GMM head's gradient entries of hidden units whose relu mask
    is ill-determined, WIDE_MASK_BAND: counted and reported) and bf16
    under 7c's (``train_step_parity``: B=4, n_query=16, T=5)."""
    from aline_tpu_torch.config import WIDE128_RECIPE, parse_overrides
    from aline_tpu_torch.models.aline import build_model
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    rec = {}
    for dtype in ("float32", "bfloat16"):
        cfg = parse_overrides(list(WIDE128_RECIPE) + [f"dtype={dtype}"])
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(cfg.seed)
            model = build_model(cfg, "cpu")
        t0 = time.perf_counter()
        near = []                       # [C, F] per plain backward call
        plain = ghk.gmm_head_bwd_plain

        def recording(z, w1, b1, w2, g):
            pre = torch.einsum("btd,cdf->btcf", z, w1) + b1
            near.append((pre.abs() <= WIDE_MASK_BAND * pre.abs().amax())
                        .any(dim=(0, 1)))
            return plain(z, w1, b1, w2, g)

        def masks():
            band = torch.stack(near).any(dim=0)
            w1 = model.head.target_head.heads_w1
            return {"head.target_head.heads_w1":
                    band[:, None, :].expand(w1.shape),
                    "head.target_head.heads_b1": band}

        undo = patched([(ghk, "gmm_head_bwd_plain", recording)])
        try:
            worst, counts = train_step_parity(
                f"wide step {dtype}", cfg, model,
                unresolved=masks if dtype == "float32" else None,
                reward_from_cpu=dtype == "bfloat16",
                witness=dtype == "bfloat16")
        finally:
            patched(undo)
        used = {n for n, c in counts.items() if c}
        want = ({"gmm_head_fwd", "gmm_head_bwd", "flash_plan",
                 "flash_attn_fwd", "flash_attn_bwd"} if dtype == "float32"
                else {"flash_plan", "flash_attn_fwd_bf16",
                      "flash_attn_bwd_bf16"})
        if used != want:
            raise AssertionError(f"wide step {dtype}: the card step "
                                 f"launched {counts}")
        rec[dtype] = dict(worst=worst, launches=counts,
                          s=time.perf_counter() - t0,
                          ill_determined_units=int(
                              torch.stack(near).any(dim=0).sum())
                          if near else 0)
    return rec


def phase_wide_eval(smi, train_rec):
    """Phase wide (c): ``eval_al``'s main on the f32 run's weights at the
    flagship's protocol, in bf16 and in f32 (copies of its config.json,
    f32 at WIDE_F32_EVAL_B rows): launches, finite curves of the right
    shapes, wall."""
    from aline_tpu_torch import eval_al
    from aline_tpu_torch.config import load_config
    from aline_tpu_torch.models.heads import FUSED_MIN_TOKENS
    src = Path(train_rec["run_dir"])
    rec = {}
    n_points, n_target = 1 + N_QUERY, 102
    forwards = 3 * (T_STEPS + 1)
    for dtype, B in (("bfloat16", BATCH), ("float32", WIDE_F32_EVAL_B)):
        run_dir = run_copy(f"wide_eval_{dtype}", dtype=dtype, src=src,
                           under=src.parent)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eval_al.main([run_dir, "--params", train_rec["params"],
                            "--batch-size", str(B), "--T", str(T_STEPS),
                            "--n-query", str(N_QUERY)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        f32 = dtype == "float32"
        per_forward = sum(int(f32 or n >= FUSED_MIN_TOKENS)
                          for n in (n_points, n_target))
        want = expected_launches(load_config(run_dir),
                                 gmm_head_fwd=per_forward * forwards,
                                 flash_plan=forwards,
                                 flash_attn_fwd=3 * forwards)
        if counts != want:
            raise AssertionError(f"wide eval {dtype}: launches {counts}, "
                                 f"expected {want}")
        finals = {}
        for name in ("aline", "random", "uncertainty"):
            lp, rm = res[f"{name}_log_prob"], res[f"{name}_rmse"]
            if lp.shape != (B, T_STEPS + 1) or not (
                    np.isfinite(lp).all() and np.isfinite(rm).all()):
                raise AssertionError(f"wide eval {dtype} {name}: curves "
                                     f"{lp.shape}, finite "
                                     f"{np.isfinite(lp).all()}")
            finals[name] = dict(ll_step0=float(lp[:, 0].mean()),
                                ll_final=float(lp[:, -1].mean()),
                                rmse_final=float(rm[:, -1].mean()))
        peak = torch.cuda.max_memory_allocated()
        rec[dtype] = dict(batch_size=B, wall_s=wall, launches=counts,
                          strategies=finals, peak_bytes=peak)
        if dtype == "bfloat16":
            # where the time goes: the same eval, WIDE_PROFILE_T steps,
            # under the profiler
            busy, pwall, top = device_busy(lambda: eval_al.main(
                [run_dir, "--params", train_rec["params"], "--batch-size",
                 str(B), "--T", str(WIDE_PROFILE_T), "--n-query",
                 str(N_QUERY)]))
            rec[dtype]["profile"] = dict(T=WIDE_PROFILE_T, busy_ms=busy,
                                         wall_ms=pwall, top_kernels_ms=top)
            log("wide eval", f"bf16 profile (T={WIDE_PROFILE_T}): device "
                f"busy {busy:.1f} of {pwall:.1f} ms ({busy / pwall:.1%}); "
                + ", ".join(f"{n[:60]} {ms:.1f}" for n, ms in top.items()))
        log("wide eval", f"{dtype}: eval_al B={B} n_query={N_QUERY} "
            f"T={T_STEPS}, three strategies: {wall:.2f} s, peak "
            f"{peak / 2**30:.3f} GiB, launches "
            f"{ {n: c for n, c in counts.items() if c} }; "
            + ", ".join(f"{n} LL {f['ll_step0']:.4f} -> {f['ll_final']:.4f}"
                        for n, f in finals.items()) + f" ({smi})")
    return rec


def phase_wide_hold(train_rec):
    """Phase wide (c): the kernel path (flash, fused GMM) against the
    no-kernel path (compact, fused_gmm=off) on the card, on the first
    WIDE_HOLD_B rows of the eval batch.  f32, as phase 4b holds flash to
    compact: along the no-kernel path's aline trajectory the design
    probabilities and posterior means within FWD_TOL; rows that choose
    alike with curves within TOL (every strategy); a row that chooses
    differently does so at a tie (log-probs within TIE).  bf16, as 4d
    holds flash to compact: along the f32 no-kernel path's aline
    trajectory (``hold_trajectory``) both bf16 paths are read against f32
    (each lies tens of bf16 ulps from it, so where a row leaves that
    trajectory is read, not held); the two bf16 paths' mean |log-prob
    difference| may not exceed that of the no-kernel path in bf16 against
    f32 (the two share every bf16 Dense rounding; the kernels keep the
    scores and the head in float32)."""
    from aline_tpu_torch.eval.al_curves import compare_strategies
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
    from aline_tpu_torch.utils.serialization import load_model
    src = Path(train_rec["run_dir"])
    models, curves, counts = {}, {}, {}
    batch = None
    for dtype in ("float32", "bfloat16"):
        for path, impl, fused in (("kernels", "flash", "auto"),
                                  ("no kernels", "compact", "off")):
            key = (dtype, path)
            run_dir = run_copy(f"wide_hold_{dtype}_{impl}", dtype=dtype,
                               attention_impl=impl, fused_gmm=fused,
                               src=src, under=src.parent)
            cfg, model = load_model(run_dir, train_rec["params"], "cuda")
            gen = torch.Generator(device="cuda").manual_seed(0)
            b = build_task(cfg.task).sample_batch(gen, WIDE_HOLD_B,
                                                  n_query=N_QUERY)
            if batch is None:
                batch = b
            elif not torch.equal(b.x, batch.x):
                raise AssertionError("wide hold: the batches differ")
            reset_launches()
            curves[key] = compare_strategies(model, b, T_STEPS, gen,
                                             time_token=cfg.time_token)
            torch.cuda.synchronize()
            counts[key] = launches()
            models[key] = model
            if (path == "no kernels") == any(counts[key].values()):
                raise AssertionError(f"wide hold {key}: launches "
                                     f"{counts[key]}")
    # f32
    model, ref_model = models[("float32", "kernels")], \
        models[("float32", "no kernels")]
    got, ref = curves[("float32", "kernels")], \
        curves[("float32", "no kernels")]
    ref_idx = ref["aline"]["idx"].cpu()
    differs, first = first_change(got["aline"]["idx"].cpu(), ref_idx)
    gap = torch.zeros(WIDE_HOLD_B)
    rows = torch.arange(WIDE_HOLD_B)
    b = init_ctx_idx(batch, min(int(batch.ctx_mask[0].sum()) + T_STEPS,
                                batch.n_points))
    fwd_err = 0.0
    with torch.no_grad():
        for t in range(T_STEPS + 1):
            out, out_r = model(b), ref_model(b)
            for x, y in ((out.design_out.zt, out_r.design_out.zt),
                         (out.posterior_out.mixture_means,
                          out_r.posterior_out.mixture_means)):
                fwd_err = max(fwd_err, (x - y).abs().max().item())
            if t == T_STEPS:
                break
            lp = out_r.design_out.zt.clamp_min(1e-30).log().cpu()
            here = differs & (first == t)
            g = lp[rows, ref_idx[:, t]] - lp[rows, got["aline"]["idx"]
                                             .cpu()[:, t]]
            gap = torch.where(here, g, gap)
            b, _, _ = select_design(b, ref["aline"]["idx"][:, t])
    same_err = 0.0
    for name in got:
        same = (got[name]["idx"] == ref[name]["idx"]).all(dim=1)
        if same.any():
            same_err = max(same_err, (got[name]["log_prob"]
                                      - ref[name]["log_prob"]).abs()[same]
                           .max().item())
    f32 = dict(rows=WIDE_HOLD_B, rows_differing=int(differs.sum()),
               max_tie_gap=gap.max().item(), forward_max_abs=fwd_err,
               same_rows_curve_max_abs=same_err)
    log("wide hold", f"f32 kernels vs no kernels ({WIDE_HOLD_B} rows): "
        f"forwards along the no-kernel aline trajectory within "
        f"{fwd_err:.3e} (limit {FWD_TOL:.0e}); {f32['rows_differing']} rows "
        f"chose differently, largest log-prob gap where they did "
        f"{f32['max_tie_gap']:.3e} (limit {TIE:.0e}); the curves of rows "
        f"that chose alike within {same_err:.3e} (limit {TOL:.0e})")
    if fwd_err > FWD_TOL or f32["max_tie_gap"] > TIE or same_err > TOL:
        raise AssertionError(f"wide hold f32: {f32}")
    # bf16
    kb, nb = curves[("bfloat16", "kernels")], \
        curves[("bfloat16", "no kernels")]
    along = hold_trajectory(
        "wide hold", batch, ref_idx, ref_model,
        {f"bf16 {p}": (models[("bfloat16", p)], c["aline"]["idx"])
         for p, c in (("kernels", kb), ("no kernels", nb))},
        WIDE_HOLD_B, T=T_STEPS)
    gaps = {"kernels bf16 vs f32": mean_curve_gap(kb, ref),
            "no kernels bf16 vs f32": mean_curve_gap(nb, ref),
            "kernels vs no kernels, bf16": mean_curve_gap(kb, nb)}
    means = {what: statistics.mean(v["mean_abs"] for v in g.values())
             for what, g in gaps.items()}
    log("wide hold", "bf16 curves, mean |dlog-prob| over rows, steps and "
        "strategies: " + ", ".join(f"{w} {m:.4f}" for w, m in means.items()))
    paths_gap = means["kernels vs no kernels, bf16"]
    plain_gap = means["no kernels bf16 vs f32"]
    if paths_gap > plain_gap:
        raise AssertionError(
            f"wide hold bf16: the paths differ by {paths_gap:.4f}, the "
            f"no-kernel path from f32 by {plain_gap:.4f}")
    return dict(f32=f32, bf16=dict(along=along, curve_gaps=gaps),
                launches={f"{d} {p}": c for (d, p), c in counts.items()})


def phase_wide(smi, paths=True):
    """Phase wide: al1d_wide128's kernels, and (``paths``) its training
    and eval; the main paths' records under "paths"."""
    rec = {"build_s": phase_build()}
    rec["kernels"], rec["errors"] = phase_wide_kernels()
    if not paths:
        return rec
    with tempfile.TemporaryDirectory(prefix="wide_") as work:
        train = {d: phase_wide_train(smi, d, Path(work))
                 for d in ("float32", "bfloat16")}
        rec["step_parity"] = phase_wide_step_parity()
        evals = phase_wide_eval(smi, train["float32"])
        rec["hold"] = phase_wide_hold(train["float32"])
    rec["paths"] = {"wide_train": train["float32"],
                    "wide_train_bf16": train["bfloat16"],
                    "wide_eval": evals["float32"],
                    "wide_eval_bf16": evals["bfloat16"],
                    "wide_hold": {"launches": {
                        n: sum(c[n] for c in rec["hold"]["launches"]
                               .values())
                        for n in launches()}}}
    return rec


def kernel_phases():
    """Phases 2-3e: {record name: rows} and {kernel: worst error}."""
    rec = {"build_s": phase_build()}
    rec["gmm_head_fwd"], gmm_err = phase_kernels()
    rec["gmm_head_bwd"], bwd_err = phase_kernels_bwd()
    rec["flash"], flash_err = phase_flash_kernels()
    rec["flash_bf16"], bf16_err = phase_flash_kernels_bf16()
    rec["fold"], fold_err = phase_fold_kernel()
    rec["ces_fold"], ces_fold_err = phase_ces_fold_kernel()
    errs = {"gmm_head_fwd": gmm_err, "gmm_head_bwd": bwd_err,
            "loc_eig_fold": fold_err, "ces_eig_fold": ces_fold_err,
            "flash_attn_fwd": flash_err["fwd"],
            "flash_attn_bwd": flash_err["bwd"],
            "flash_attn_fwd_bf16": bf16_err["fwd"],
            "flash_attn_bwd_bf16": bf16_err["bwd"]}
    return rec, errs


def kernel_records(rec, errs, paths, wide=None):
    """The kernels line: every kernel at its main shape, with its launches
    by path (``paths``: {path: record with "launches"}; None where no main
    path ran, and then the launches are null; no rows where ``rec`` is
    None); with ``wide`` (phase wide's record) each kernel again at
    al1d_wide128's shapes (``"case": "al1d_wide128"``), its launches on
    the wide paths."""
    def record(name, replaces, row, source=None, dtype="float32", errs=errs,
               paths=paths, **extra):
        by_path = (None if paths is None else
                   {p: r["launches"][name] for p, r in paths.items()})
        return {"name": name, "route": "cuda",
                "source": f"aline_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "dtype": dtype, **extra,
                "launches": None if by_path is None else sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": errs.get(name, 0.0),
                "ms": row["ms"], "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **{k: row[k] for k in ("fma_bound_ms", "tc_bound_ms",
                                       "dense_bound_ms") if k in row},
                "shape": row.get("shape", [row.get("B"), row.get("T")])}

    rows = []
    if rec is not None and "gmm_head_fwd" in rec:
        rows += narrow_records(rec, record)
    if rec is not None and "fold" in rec:
        f = rec["fold"]
        # no Pallas kernel: it stands where XLA fuses the chunk fold
        rows.append(record(
            "loc_eig_fold", None, f,
            fuses="aline_tpu/eval/eig.py:79 _accumulate_chunks",
            **{k: f[k] for k in ("Lc", "last_chunk", "chunks_per_batch",
                                 "batch_ms", "batch_bound_ms")}))
    if rec is not None and "ces_fold" in rec:
        f = rec["ces_fold"]
        rows.append(record(
            "ces_eig_fold", None, f,
            fuses="aline_tpu/eval/eig.py:79 _accumulate_chunks",
            **{k: f[k] for k in ("Lc", "last_chunk", "chunks_per_batch",
                                 "batch_ms", "batch_bound_ms",
                                 "max_share_of_tolerance")}))
    if wide is None:
        return rows
    k = wide["kernels"]
    w = dict(errs=wide["errors"], paths=wide.get("paths"),
             case="al1d_wide128")
    return rows + [
        record("gmm_head_fwd", "aline_tpu/ops/gmm_head_kernel.py:27",
               k["gmm"]["fwd wide pool"], **w),
        record("flash_plan", None, k["flash"]["wide_eval"]["plan"],
               serves=["flash_attn_fwd", "flash_attn_bwd"], **w),
        record("gmm_head_bwd", "aline_tpu/ops/gmm_head_kernel.py:41",
               k["gmm"]["bwd wide train targets"], **w),
        record("flash_attn_fwd", "aline_tpu/ops/flash_attention.py:43",
               k["flash"]["wide_eval"]["fwd"], **w),
        record("flash_attn_bwd", "aline_tpu/ops/flash_attention.py:65",
               k["flash"]["wide_train"]["bwd"], **w),
        record("flash_attn_fwd_bf16", "aline_tpu/ops/flash_attention.py:43",
               k["flash_bf16"]["wide_eval"]["fwd"], source="flash_attn_fwd",
               dtype="bfloat16", **w),
        record("flash_attn_bwd_bf16", "aline_tpu/ops/flash_attention.py:65",
               k["flash_bf16"]["wide_train"]["bwd"], source="flash_attn_bwd",
               dtype="bfloat16", **w)]


def narrow_records(rec, record):
    """The kernels line's rows of phases 3-3d (the flagship's shapes)."""
    flash, bf16 = rec["flash"], rec["flash_bf16"]
    return [
        record("gmm_head_fwd", "aline_tpu/ops/gmm_head_kernel.py:27",
               rec["gmm_head_fwd"]["pool"]),
        # no Pallas kernel of its own: it lists the pairs that both flash
        # kernels walk
        record("flash_plan", None, flash["eval"]["plan"],
               serves=["flash_attn_fwd", "flash_attn_bwd"]),
        record("gmm_head_bwd", "aline_tpu/ops/gmm_head_kernel.py:41",
               rec["gmm_head_bwd"]["train targets"]),
        record("flash_attn_fwd", "aline_tpu/ops/flash_attention.py:43",
               flash["eval"]["fwd"]),
        record("flash_attn_bwd", "aline_tpu/ops/flash_attention.py:65",
               flash["train"]["bwd"]),
        # the bf16 forms: the same sources' *_bf16 entry points
        record("flash_attn_fwd_bf16", "aline_tpu/ops/flash_attention.py:43",
               bf16["eval"]["fwd"], source="flash_attn_fwd",
               dtype="bfloat16"),
        record("flash_attn_bwd_bf16", "aline_tpu/ops/flash_attention.py:65",
               bf16["train"]["bwd"], source="flash_attn_bwd",
               dtype="bfloat16")]


def main(argv=None):
    args = parse_args(argv)
    smi = phase_device()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
    if args.only:
        t0 = time.perf_counter()
        rec, kernels = {}, None
        if "kernels" in args.only:
            rec, errs = kernel_phases()
            kernels = kernel_records(rec, errs, None)
        elif "fold" in args.only:
            rec["fold"], fold_err = timed("3e", phase_fold_kernel)
            rec["ces_fold"], ces_fold_err = timed("3e ces",
                                                  phase_ces_fold_kernel)
            errs = {"loc_eig_fold": fold_err, "ces_eig_fold": ces_fold_err}
            kernels = kernel_records(rec, errs, None)
        if "bed" in args.only:
            rec["bed"] = timed("8", phase_bed, smi)
            rec["bed_witness"] = timed("8b", phase_bed_witness)
        if "train_loc" in args.only:
            rec["train_loc"] = timed("9", phase_train_loc, smi)
        if "wide" in args.only or "wide_kernels" in args.only:
            rec["wide"] = phase_wide(smi, "wide" in args.only)
            kernels = kernel_records(rec if kernels else None,
                                     errs if kernels else {}, None,
                                     wide=rec["wide"])
        rec.update(new_phases(smi, args.only, args.ces_M, GP["batch_size"]))
        if set(args.only) & set(DIST_PHASES):
            rec.update(dist_phases(smi, args.only))
        rec["wall_s"] = time.perf_counter() - t0
        (OUT_DIR / f"chip_smoke_{'_'.join(args.only)}.json").write_text(
            json.dumps(dict(nvidia_smi=smi, torch=torch.__version__,
                            device=device, **rec, kernels=kernels), indent=1,
                       default=str))
        print(smi)
        if kernels is not None:
            print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": device}))
        return
    t_run = time.perf_counter()
    kernel_rec, errs = timed("kernels 2-3e", kernel_phases)
    wide_rec = timed("wide", phase_wide, smi)
    torch.cuda.empty_cache()
    slice_rec, batch, curves = timed("4", phase_slice)
    flash_slice_rec = timed("4b", phase_flash_slice, batch, curves)
    bf16_slice_rec, bf16_curves, model_c = timed("4c", phase_slice_bf16,
                                                 batch, curves)
    bf16_flash_slice_rec = timed("4d", phase_flash_slice_bf16, batch,
                                 bf16_curves, model_c, curves)
    del batch, curves, bf16_curves, model_c
    parity_err = timed("5", phase_parity)
    train_rec = timed("6", phase_train, smi)
    flash_train_rec = timed("6b", phase_train, smi, "flash train",
                            FLASH_TRAIN_ARGS)
    bf16_train_rec = timed("6c", phase_train, smi, "bf16 train",
                           BF16_TRAIN_ARGS)
    bf16_flash_train_rec = timed("6c flash", phase_train, smi,
                                 "bf16 flash train",
                                 BF16_TRAIN_ARGS + FLASH_TRAIN_ARGS)
    train_parity_err = timed("7", phase_train_parity)
    flash_parity_err = timed("7b", phase_flash_train_parity)
    bf16_parity = timed("7c", phase_train_parity_bf16)
    bed_rec = timed("8", phase_bed, smi)
    bed_witness = timed("8b", phase_bed_witness)
    loc_train_rec = timed("9", phase_train_loc, smi)
    task_recs = timed("10-18, 22-24", new_phases, smi, NEW_PHASES,
                      args.ces_M, GP_SMOKE_B)
    dist_recs = timed("19-21", dist_phases, smi, DIST_PHASES)
    WALLS["all"] = time.perf_counter() - t_run

    paths = {"eval": slice_rec, "train": train_rec,
             "flash_eval": flash_slice_rec, "flash_train": flash_train_rec,
             "eval_bf16": bf16_slice_rec, "train_bf16": bf16_train_rec,
             "flash_eval_bf16": bf16_flash_slice_rec,
             "flash_train_bf16": bf16_flash_train_rec, "bed": bed_rec,
             "train_loc": loc_train_rec, "ces_bed": task_recs["ces_bed"],
             "train_ces": task_recs["train_tasks"]["ces"],
             "gp": task_recs["gp"],
             "bench": task_recs["bench"],
             "train_continuous": task_recs["cont"]["reinforce"],
             "train_continuous_pathwise": task_recs["cont"]["pathwise"],
             "dad": task_recs["dad"], "trend": task_recs["trend"],
             "demo_eval": task_recs["demo_eval"],
             "demo_train": task_recs["demo_train"],
             "dp": dist_recs["dp"], "mesh": dist_recs["mesh"],
             "seq": dist_recs["seq"], "seq_flash": dist_recs["seq_flash"],
             **{k: {"launches": v}
                for k, v in dist_recs["settings_paths"].items()}}
    kernels = kernel_records(kernel_rec, errs, paths, wide=wide_rec)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, torch=torch.__version__, walls=WALLS, **kernel_rec,
        wide=wide_rec,
        slice=slice_rec, flash_slice=flash_slice_rec,
        slice_bf16=bf16_slice_rec, flash_slice_bf16=bf16_flash_slice_rec,
        parity_max_abs=parity_err, train=train_rec,
        flash_train=flash_train_rec, train_bf16=bf16_train_rec,
        flash_train_bf16=bf16_flash_train_rec,
        train_parity_max_abs=train_parity_err,
        flash_train_parity_max_abs=flash_parity_err,
        train_parity_bf16=bf16_parity, bed=bed_rec,
        bed_witness=bed_witness, train_loc=loc_train_rec, **task_recs,
        **dist_recs, kernels=kernels, device=device),
        indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
