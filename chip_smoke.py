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
             shapes: forward ``close()`` at 1e-4, backward ``grads_close()``
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
3d. bf16 flash kernels — the bf16 forms of the flash forward (eval,
             training and burning shapes) and backward (training, burning)
             against their plain versions in bf16 on the card: O and dQ
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
             with a float32 operand (p, dS) at 67 (``tc_bound_ms``; all at
             67: ``fma_bound_ms``); library: SDPA in bf16.
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
             flash path on the CPU (3 rows), and against 4c: flash keeps
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
             pce - 1e-5 in every row and step; no kernel launched (none
             of the path's shapes takes one); wall time split into the
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
             per-step bounds at eval.*_final with M_final cut to 200; no
             kernel launched; warm epoch, the hook's wall and peak memory.

Phases 10-13 run the remaining tasks of the paper on their banked
checkpoints, in their bf16, through the entry points; no kernel lies on
these paths, and each phase checks that none was launched:

10. ces bed — ``eval_bed``'s ``main`` on checkpoints/ces_200k at the JAX
             run's protocol (T=15, L=1e7, n_query=2000, batch 100, seed 0)
             with the random baseline, M cut to CES_SMOKE_M=200 (named in
             its log line; ``--ces-M 2000`` runs the full protocol): the
             final sPCE of both within SIGMAS combined standard errors of
             the JAX package's at M=2000 on a TPU (the port's SEs are its
             own), nmc >= pce - 1e-5 in every row and step; the rollout
             against the EIG stage, that stage per batch against its fused
             bound (``ces_fold_bound``), peak memory.
10b. ces witness — the censored log-density card vs CPU in both tail
             modes on a grid of limits with |z| up to 200, values inside
             and outside (tolerance as tests/test_torch_ces.py holds the
             port to JAX); the CES bounds of card traces on 20,000
             CPU-drawn thetas card vs CPU within 1e-5 relative plus what
             float32 rounding may move the log-likelihoods by
             (``ces_loglik_rounding``); one chunk's peak memory; one bound
             under ``torch.cuda.set_sync_debug_mode("error")``.
11. psych   — ``eval_psychometric`` and ``eval_psi`` (``main``) on
             checkpoints/psych_100k (B=100, n_query=300, T=30, seeds 0, 1,
             2, three masks): each final mean LL and RMSE over the 300
             rows within SIGMAS combined standard errors of the JAX
             package's (benchmarks/artifacts/psych_r4_100k_curves.npz,
             psych_psi_curves.npz; read with numpy); two-step PSI and
             random rollouts under set_sync_debug_mode("error").
12. hpo     — ``eval_hpo`` (``main``) on the six checkpoints/hpo_* runs
             (the fixed test set, T=30, n_query=100, n_target=100): the
             policy's final mean LL and RMSE within SIGMAS combined
             standard errors of the run's JAX curves; the rows whose curve
             leaves the artifact's by more than the step-0 rounding gap,
             and by how much.
13. train tasks — ``train``'s ``main`` on the ces (EIG hook once),
             psychometric (predefined masks) and hpo (rpart) recipes in
             bf16, B=200, 2 burning and 3 main epochs: finite losses, warm
             epoch ms, peak memory.

Phases 14-18 run the paper's baselines and the remaining design paths
through their entry points; only 16 lies on a kernel:

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
             pce - 1e-5; one step card vs CPU held at PARITY_T steps and
             at T=30, the card's REINFORCE reward the CPU's.
17. dad     — ``train_dad``'s ``main`` at its DEFAULTS for DAD_EPOCHS
             epochs: no kernel, epochs/s, peak memory, final bounds at
             L=1e6, M=200; one step card vs CPU as in 16.
18. trend   — ``eval_bed_trend``'s ``main`` on loc_100k (bf16, M=200,
             batch 100, n_query=2000, L = 1e4, 1e5, 1e6): nmc >= pce -
             1e-5 at every L, the L=1e6 row bit for bit
             ``eval_eig_from_history``'s on the same traces and seed; no
             kernel.

``--only ces psych hpo train_tasks bench cont dad trend gp`` runs phase 1
and the named ones of 10-18 alone (no kernels line); with no arguments
it runs every phase.

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
            if "registers" in line or "spill" in line:
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
              (200, 2, "continuous train"), (5, 2, "continuous greedy")]
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
        nbytes = 4 * sum(t.numel() for t in args) + 4 * got.numel()
        row = dict(
            B=B, T=T, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=time_ms(lambda: ghk.gmm_head_fwd(*args)),
            device_ms=device_ms(lambda: ghk.gmm_head_fwd(*args)),
            plain_ms=time_ms(lambda: ghk.gmm_head_fwd_plain(*args)),
            # the two-einsum formula, timed as the library yardstick
            library_ms=time_ms(lambda: torch.einsum(
                "btcf,cfo->btco", torch.relu(
                    torch.einsum("btd,cdf->btcf", z, w1) + b1), w2) + b2),
            **gmm_bound(2 * B * T * C * D * F, 2 * B * T * C * 3 * F, nbytes))
        rows[what] = row
        log("kernels", f"gmm_head_fwd {what} B={B} T={T}: max abs err "
            f"{abs_err:.3e}, max rel err {rel_err:.3e}; kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, two-einsum "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; FMA bound {row['fma_bound_ms']:.4f} ms)")
    return rows, worst


def split_bound(tc_s, tc_flops, other_flops, nbytes):
    """The least time of a kernel's two forms: every FLOP on float32 FMAs
    (``fma_bound_ms``), or ``tc_flops`` of them on the tensor cores, in
    ``tc_s`` seconds, and the rest on FMAs (``tc_bound_ms``); each against
    the bytes."""
    fma = bound(tc_flops + other_flops, nbytes)
    t_tc = tc_s + other_flops / PEAK_F32_FLOPS
    tc = max(t_tc, nbytes / PEAK_HBM_BYTES) * 1e3
    best = (dict(bound_ms=tc, bound_by="operations" if t_tc >= nbytes /
                 PEAK_HBM_BYTES else "bytes")
            if tc <= fma["bound_ms"] else
            dict(bound_ms=fma["bound_ms"], bound_by=fma["bound_by"]))
    return dict(best, fma_bound_ms=fma["bound_ms"], tc_bound_ms=tc,
                flops=tc_flops + other_flops, bytes=nbytes)


def gmm_bound(mma_flops, other_flops, nbytes):
    """A GMM kernel's bound: its D x F products (``mma_flops``) as 3xTF32
    on the tensor cores (three TF32 products each), or on FMAs."""
    return split_bound(3 * mma_flops / PEAK_TF32_FLOPS, mma_flops,
                       other_flops, nbytes)


def bf16_flash_bound(bf16_flops, f32_flops, nbytes):
    """A bf16 flash kernel's bound: its products of two bfloat16 operands
    (``bf16_flops``: q·kᵀ, and dO·vᵀ in the backward) at the bf16 tensor
    cores' rate with float32 sums, those with a float32 operand (p or dS)
    on FMAs."""
    return split_bound(bf16_flops / PEAK_BF16_FLOPS, bf16_flops, f32_flops,
                       nbytes)


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
              (3, 37, "ragged"), (200, 2, "continuous train")]
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


def _counters():
    from aline_tpu_torch.ops import flash_attention as fa
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    return ghk.LAUNCHES, fa.LAUNCHES


def reset_launches():
    for counter in _counters():
        for name in counter:
            counter[name] = 0


def launches():
    """Every kernel's launches since the last reset."""
    return {name: n for counter in _counters() for name, n in counter.items()}


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
}
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


def phase_flash_kernels():
    from aline_tpu_torch.ops import flash_attention as fa
    rows, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for seed, (what, case) in enumerate(FLASH_CASES.items()):
        q, k, v, kcode, qrow, do = flash_inputs(*case, seed=30 + seed)
        B, H, N, dh = q.shape
        blind = case[6]
        plan, plan_rec = phase_flash_plan(kcode, qrow, what)
        # the check: the first CHECK_ROWS batch rows at the eval shapes
        n = CHECK_ROWS if what in PLAIN_BWD_EVAL else B
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
        grads = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
        again = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_attn_bwd is not deterministic at "
                                 f"{what}")
        refs = {"plain": fa.flash_attn_bwd_plain(cq, ck, cv, ckc, cqr, o, lse,
                                                 cdo)}
        if not blind:
            # autograd of the replaced scores gives a row that sees no key
            # no gradient; the kernels follow the TPU kernel there
            leaves = [t.clone().requires_grad_() for t in (cq, ck, cv)]
            out = fa.flash_attn_fwd_plain(*leaves, ckc, cqr)[0]
            refs["autograd"] = torch.autograd.grad(out, leaves, cdo)
        for ref_name, ref in refs.items():
            for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
                err, ok = grads_close(a, r)
                if not ok:
                    raise AssertionError(
                        f"flash_attn_bwd {name} disagrees with {ref_name} "
                        f"at {what}: max abs {err:.3e}")
                errs[f"{name} vs {ref_name}"] = err
        del refs, grads, again, ref_o, ref_lse
        worst["fwd"] = max(worst["fwd"], errs["O"], errs["lse"])
        worst["bwd"] = max(worst["bwd"], *(e for name, e in errs.items()
                                           if name.startswith("d")))

        # timings at full B, the kernels with the plan built above
        kc = kcode[:, None, None, :]
        allowed = (kc == 1) | ((qrow[:, None, :, None] == 1) & (kc == 2))
        o, lse = fa.flash_attn_fwd(q, k, v, kcode, qrow, plan)
        small = (4 * B * H * N * N <= PLAIN_BWD_MAX_BYTES
                 or what in PLAIN_BWD_EVAL)
        rec = dict(shape=[B, H, N, dh], n_checked=n, errors=errs,
                   plan=plan_rec)
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
                if small else None)
        rec["bwd"] = dict(
            shape=[B, H, N, dh],
            ms=time_ms(lambda: fa.flash_attn_bwd(q, k, v, kcode, qrow, o,
                                                 lse, do, plan)),
            device_ms=device_ms(lambda: fa.flash_attn_bwd(q, k, v, kcode,
                                                          qrow, o, lse, do,
                                                          plan)),
            plain_ms=(time_ms(lambda: fa.flash_attn_bwd_plain(
                q, k, v, kcode, qrow, o, lse, do), reps=3, iters=3)
                if small else None),
            library_ms=(time_ms(lambda: torch.autograd.grad(
                sdpa, leaves, do, retain_graph=True)) if small else None),
            dense_bound_ms=bound(10 * dense * dh, bwd_bytes)["bound_ms"],
            pairs=pairs, dense_pairs=dense,
            **bound(10 * pairs * dh, bwd_bytes))
        rows[what] = rec
        for part in ("fwd", "bwd"):
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
            + "; backward bitwise repeatable")
        del q, k, v, do, o, lse, allowed, plan, leaves, sdpa
        torch.cuda.empty_cache()
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
             src=RUN_DIR):
    """A copy of the flagship's run directory, or of ``src`` (its
    config.json only, with the given changes) under ``OUT_DIR``, for
    ``load_model`` and the entry points, which write under it."""
    run_dir = OUT_DIR / name
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
                      flash_attn_fwd=0, flash_attn_bwd=0):
    """Every counter's expected launches on a path of ``cfg``: the flash
    counts go to the run's dtype's entries, and to none without flash."""
    from aline_tpu_torch.models.aline import compute_dtype
    want = {name: 0 for name in launches()}
    want.update(gmm_head_fwd=gmm_head_fwd, gmm_head_bwd=gmm_head_bwd)
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


def train_step_parity(label, cfg, model_cpu, *, time_token=False):
    """One optimizer step of ``model_cpu`` on the CPU (plain versions)
    and of a copy on the card (kernels), from the same B=4, n_query=16,
    T=5 batch with the data mask and the same Gumbel noise.  In float32
    the losses are held to 1e-4 and the gradients element by element (see
    below); in bfloat16 (``model_cpu`` computing in it) the losses to
    ``BF16_LOSS_RTOL`` of the loss's scale and each parameter's gradient to
    a relative L2 error of ``BF16_GRAD_RTOL``, without the entries that
    shift every logit of a softmax alike (``shift_invariant``).  Returns
    the worst error and the card step's launches."""
    from aline_tpu_torch.models.aline import compute_dtype
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
    runs, idx = {}, {}
    for name, model, dev in (("cpu", model_cpu, "cpu"),
                             ("gpu", model_gpu, "cuda")):
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
    counts = launches()
    (m_c, p_c, g_c), (m_g, p_g, g_g) = runs["cpu"], runs["gpu"]
    if not torch.equal(idx["cpu"], idx["gpu"]):
        raise AssertionError(f"{label}: CPU and card drew different designs "
                             f"from the same noise")
    if bf16:
        return bf16_step_parity(label, cfg, model_cpu, m_c, m_g, g_c,
                                g_g), counts
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
    for n, g in g_c.items():
        err = (g_g[n] - g).abs()
        if not bool((err <= TOL * g.abs() + TOL * scale).all()):
            raise AssertionError(f"{label}: grad of {n} differs between "
                                 f"CPU and card by {err.max():.3e}")
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
BF16_FLASH_CASES = {"eval": ("fwd",), "train": ("fwd", "bwd"),
                    "burning": ("fwd", "bwd")}
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
BF16_FLASH_WITNESS_ROWS = 3  # 4d: the flash plain versions on the CPU
# Phase 7c: one bf16 step on the card against one on the CPU.  Where the
# float32 sums inside the bf16 layers run in other orders, a bf16 rounding
# moves, and the move reaches every gradient through the backward pass.
# On an NVIDIA H100 80GB HBM3 the worst parameter read 0.25% (compact),
# 0.32% (fused_gmm=on) and 2.6% (flash with the time token).
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 4e-2


def bf16_close(got, ref, floor):
    """(max abs error, within tolerance) for a bf16 output: one bf16 ulp
    of each element plus ``floor`` of ref's largest element."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool((err <= BF16_ULP * ref.abs() + floor * ref.abs().max()).all())
    return err.max().item(), ok


def phase_flash_kernels_bf16():
    """3d: the bf16 flash kernels at the eval, training and burning
    shapes against their plain versions in bf16 on the card; times."""
    from aline_tpu_torch.ops import flash_attention as fa
    rows, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for seed, (what, parts) in enumerate(BF16_FLASH_CASES.items()):
        q, k, v, kcode, qrow, do = (
            t.to(BF16) if t.is_floating_point() else t
            for t in flash_inputs(*FLASH_CASES[what], seed=60 + seed))
        B, H, N, dh = q.shape
        plan = fa.flash_plan(kcode, qrow)
        n = CHECK_ROWS if what in PLAIN_BWD_EVAL else B
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
        if "bwd" in parts:
            grads = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
            again = fa.flash_attn_bwd(cq, ck, cv, ckc, cqr, o, lse, cdo)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"bf16 flash_attn_bwd is not "
                                     f"deterministic at {what}")
            ref = fa.flash_attn_bwd_plain(cq, ck, cv, ckc, cqr, o, lse, cdo)
            blocks = -(-N // fa.block_q(N))
            floors = (TOL, *(2 * [(blocks + 1) * 2.0 ** -8]))
            for name, a, r, floor in zip(("dq", "dk", "dv"), grads, ref,
                                         floors):
                err, ok = bf16_close(a, r, floor)
                if not (ok and a.dtype == BF16):
                    raise AssertionError(
                        f"bf16 flash_attn_bwd {name} disagrees with its "
                        f"plain version at {what}: max abs {err:.3e} "
                        f"(largest {r.float().abs().max():.3e})")
                errs[name] = err
            # the kernel's own sums: over all rows in float32, rounded once
            once = fa.flash_attn_bwd_plain(cq, ck, cv, ckc, cqr, o, lse, cdo,
                                           per_block=False)
            for name, a, r in zip(("dk", "dv"), grads[1:], once[1:]):
                err, ok = bf16_close(a, r, TOL)
                if not ok:
                    raise AssertionError(
                        f"bf16 flash_attn_bwd {name} disagrees with the plain "
                        f"version summed once at {what}: max abs {err:.3e}")
                errs[f"{name} vs summed once"] = err
            del grads, again, ref, once
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
        if "bwd" in parts:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
            rec["bwd"] = dict(
                shape=[B, H, N, dh],
                ms=time_ms(lambda: fa.flash_attn_bwd(q, k, v, kcode, qrow, o,
                                                     lse, do, plan)),
                device_ms=device_ms(lambda: fa.flash_attn_bwd(
                    q, k, v, kcode, qrow, o, lse, do, plan)),
                plain_ms=time_ms(lambda: fa.flash_attn_bwd_plain(
                    q, k, v, kcode, qrow, o, lse, do), reps=3, iters=3),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    sdpa, leaves, do, retain_graph=True)),
                pairs=pairs, **bf16_flash_bound(4 * pairs * dh,
                                                6 * pairs * dh, bwd_bytes))
            del leaves, sdpa
        rows[what] = rec
        for part in parts:
            r = rec[part]
            log("kernels", f"bf16 flash_attn_{part} {what} B={B} H={H} "
                f"N={N} dh={dh}: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, SDPA "
                f"bf16 {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']}; FMA bound {r['fma_bound_ms']:.4f} "
                f"ms)")
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

    from aline_tpu_torch.utils.profiling import busy_us
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
    return busy_us(kernels) / 1e3, wall * 1e3, dict(ranked)


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


def bf16_step_parity(label, cfg, model, m_c, m_g, g_c, g_g):
    """The bf16 checks of ``train_step_parity``: losses and per-parameter
    gradients of the card step against the CPU step."""
    worst = 0.0
    # the design loss is a small difference of normalised rewards: each
    # term is held to BF16_LOSS_RTOL of the loss's scale
    scale = abs(float(m_c["predict_loss"])) + abs(float(m_c["design_loss"]))
    for k in ("loss", "design_loss", "predict_loss"):
        a, r = float(m_g[k]), float(m_c[k])
        if abs(a - r) > BF16_LOSS_RTOL * scale:
            raise AssertionError(f"{label} {k}: CPU {r:.6f}, card {a:.6f}")
    invariant = shift_invariant(model)
    worst_name = None
    for n, g in g_c.items():
        keep = ~invariant.get(n, torch.zeros(g.shape, dtype=torch.bool))
        ref, got = g[keep], g_g[n][keep]
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        if rel > BF16_GRAD_RTOL:
            raise AssertionError(f"{label}: grad of {n} differs between CPU "
                                 f"and card by {rel:.3e} (relative L2)")
        if rel > worst:
            worst, worst_name = rel, n
    log(label, f"one bf16 step, B=4 n_query=16 T=5, attention_impl="
        f"{cfg.encoder.attention_impl}, fused_gmm={cfg.head.fused_gmm}: "
        f"loss CPU {float(m_c['loss']):.6f}, card {float(m_g['loss']):.6f}, "
        f"same designs; per-parameter gradients within {worst:.3e} "
        f"(relative L2, {worst_name}; limit {BF16_GRAD_RTOL})")
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


def eig_fold_bound(terms, K, D):
    """Bounds of the EIG chunk fold over ``terms`` (l, b, t) terms of
    location finding with K sources in D dimensions, from the code of
    ``tasks/location_finding.py`` and ``eval/eig.py``:

    * fused, in registers: per term 2KD + 2K + 8 float32 instructions
      (differences, squares, the sums, the offsets, the Gaussian's
      centring, scaling and square, the cumulative sum, the shift and the
      sum of the fold) and K + 2 special-function ones (K reciprocals, a
      log, an exp); its bytes (the thetas' draws, the [B, Th] inputs and
      outputs) are negligible beside them, so operations bound it.
    * eager, as PyTorch runs it: 4KD + 6K + 25 float32 passes (reads plus
      writes) over the [Lc, B, Th] block per term: the [.., K, D]
      differences and squares, 12 elementwise passes, the cumulative sum
      and the fold's max, shift, exp and sum, at the HBM rate.

    Returns (fused seconds, eager seconds)."""
    f32 = terms * (2 * K * D + 2 * K + 8) / PEAK_F32_INSTR
    mufu = terms * (K + 2) / PEAK_MUFU_INSTR
    eager = terms * 4 * (4 * K * D + 6 * K + 25) / PEAK_HBM_BYTES
    return max(f32, mufu), eager


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
                       pce=out[0].cpu(), nmc=out[1].cpu())
        store.append(rec)
        return out
    return wrapper


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
    in every row and step, no kernel launched, wall time split into the
    rollout and the EIG stage, the EIG stage per batch against its
    bounds, peak memory, and the device busy share of one batch."""
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
    if counts != expected_launches(cfg):
        raise AssertionError(f"bed: kernel launches {counts}, expected none")
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
    bound_s, eager_s = eig_fold_bound(terms, cfg.task.K, cfg.task.dim_x)
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
    ``eval.EIG=true``, through its ``main``: no kernel launched; finite
    in-training bounds in metrics.jsonl; warm ms per epoch, the hook's
    wall time and peak memory."""
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
                                                     entry.eval_boed))])
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
    if counts != expected_launches(trainer.cfg):
        raise AssertionError(f"train loc: launches {counts}, expected none")
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
# kernel runs on these paths: the GMM kernel takes token sets of 1024 or
# more in bf16 (the BED traces read the 5 theta tokens only; the
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
    fused in registers, from the code of ``tasks/ces.py`` with everything
    that does not depend on l hoisted: per basket three ex2 (x_i^rho from
    a hoisted log2 x_i) and a lg2 and an ex2 for the outer power, so 10
    special-function results, and one exp of the fold; 40 float32
    instructions (the powers' products, the weighted sums, the difference,
    the scale, the z-score and the Gaussian, the cumulative sum and the
    fold's max, shift and sum).  The data's y lie at a limit or inside
    per (b, t), so no term needs both branches; the limit's log_ndtr is
    not counted.  Returns seconds (operations bound it)."""
    return max(terms * 40 / PEAK_F32_INSTR, terms * 11 / PEAK_MUFU_INSTR)


def phase_ces_bed(smi, M):
    """10: ``python -m aline_tpu_torch.eval_bed`` on ces_200k at the JAX
    run's protocol (T=15, L=1e7, n_query=2000, batch 100) with M rows,
    through its ``main``: final sPCE of the policy and of random designs
    within SIGMAS combined standard errors of the JAX package's on a TPU
    (M=2000 there), nmc >= pce - BED_NMC_SLACK in every row and step, no
    kernel launched; wall time split into the rollout and the EIG stage,
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
    if counts != expected_launches(cfg):
        raise AssertionError(f"ces bed: kernel launches {counts}, "
                             f"expected none")
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
        f"(limit -{BED_NMC_SLACK}); no kernel launched")
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
    peak memory of one chunk of the fold at the BED shape; and one bound
    with any host synchronisation an error."""
    from aline_tpu_torch.distributions.censored_sigmoid_normal import (
        CensoredSigmoidNormal)
    from aline_tpu_torch.eval.eig import chunk_size, compute_eig_from_history
    from aline_tpu_torch.eval.traces import get_traces
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
    S = torch.cumsum(task.log_likelihood(cpu_in[2][None], cpu_in[1][None],
                                         thetas[:, :, None])[..., 0], -1)
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
    no kernel launched, warm epoch ms and peak memory; CES's EIG hook
    once, finite, and its final bounds."""
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
                            calls, "eval_boed", entry.eval_boed))])
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
        if any(counts.values()):
            raise AssertionError(f"train {task}: launches {counts}")
        epochs = [c for c in calls if c["kind"] == "epoch"]
        if not all(math.isfinite(e["loss"]) for e in epochs):
            raise AssertionError(f"train {task}: losses {epochs}")
        warm_ms = 1e3 * statistics.median(
            [e["s"] for e in epochs if e["phase"] == "main"][1:])
        r = dict(epochs=epochs, warm_ms=warm_ms, peak_bytes=peak)
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
            f"no kernel launched ({smi})")
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
DAD_EPOCHS = 300
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


def cpu_reward(seen):
    """``total_loss`` whose REINFORCE reward comes from the CPU pass: the
    CPU's call keeps its ``nll_query`` in ``seen``, the card's takes it in
    place of its own (the reward is detached, so the gradient sees a
    constant either way) and reads into ``seen`` what its own would have
    changed: the gains whose clamp at 0 it sets otherwise (``flips``) and
    the design loss (``design_loss_move``)."""
    from aline_tpu_torch.train.loss import reinforce_losses, total_loss

    def loss(ro, gamma, alpha_design):
        own = ro.nll_query.detach()
        if own.device.type == "cpu":
            seen["cpu"] = own
            return total_loss(ro, gamma, alpha_design)
        ref, mine = seen["cpu"], own.cpu()
        ro_ref = ro._replace(nll_query=ref.to(own.device))
        seen.update(
            flips=int(((ref[:-1] - ref[1:] > 0)
                       != (mine[:-1] - mine[1:] > 0)).sum()),
            nll_query_max_abs_err=(mine - ref).abs().max().item(),
            design_loss_move=abs(reinforce_losses(ro, gamma)[0].item()
                                 - reinforce_losses(ro_ref, gamma)[0].item()))
        return total_loss(ro_ref, gamma, alpha_design)
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
        pce, nmc = check_final_bounds(f"cont {label}", run["bounds"])
        least = final_bounds_rows(calls)
        bounds_s = [c["s"] for c in calls if c["kind"] == "bounds"][0]
        warm_ms = 1e3 * statistics.median(
            [e["s"] for e in epochs if e["phase"] == "main"][1:])
        totals = {k: sum(e["launches"][k] for e in epochs) + greedy[k]
                  for k in greedy}
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
            f"batches; warm epoch {warm_ms:.1f} ms; final bounds (L="
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
    no kernel launched, finite final bounds with nmc >= pce - 1e-5,
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
    if any(counts.values()):
        raise AssertionError(f"dad: launches {counts}")
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
        f"{nmc:.4f}; peak memory {peak / 2**30:.3f} GiB; no kernel "
        f"launched ({smi})")
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
    ``eval_eig_from_history`` at that L on the same traces and seed; no
    kernel launched; wall time."""
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
    undo = patched([(ebt, "get_traces", recorded)])
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
    if counts != expected_launches(cfg):
        raise AssertionError(f"trend: launches {counts}, expected none")
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
        f"{wall:.3f} s; no kernel launched ({smi})")
    return dict(rows=rows, wall_s=wall, direct_s=direct_s, launches=counts)


NEW_PHASES = ("ces", "psych", "hpo", "train_tasks", "gp", "bench", "cont",
              "dad", "trend")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke run of the port on one NVIDIA GPU; with no "
                    "arguments, every phase")
    ap.add_argument("--only", nargs="+", choices=NEW_PHASES,
                    help="run only these of phases 10-18 (after phase 1) "
                         "and print no kernels line")
    ap.add_argument("--ces-M", type=int, default=CES_SMOKE_M,
                    help="phase 10's rows (2000: the JAX run's protocol)")
    return ap.parse_args(argv)


def new_phases(smi, only, ces_M, gp_B):
    """Phases 10-18 (those named in ``only``), phase 14 with ``gp_B``
    problems: {name: record}."""
    rec = {}
    if "ces" in only:
        rec["ces_bed"] = phase_ces_bed(smi, ces_M)
        rec["ces_witness"] = phase_ces_witness()
    if "psych" in only:
        rec["psychometric"] = phase_psych(smi)
    if "hpo" in only:
        rec["hpo"] = phase_hpo(smi)
    if "train_tasks" in only:
        rec["train_tasks"] = phase_train_tasks(smi)
    if "bench" in only:
        rec["bench"] = phase_bench(smi)
    if "cont" in only:
        rec["cont"] = phase_cont(smi)
    if "dad" in only:
        rec["dad"] = phase_dad(smi)
    if "trend" in only:
        rec["trend"] = phase_trend(smi)
    if "gp" in only:
        rec["gp"] = phase_gp(smi, gp_B)
    return rec


def main(argv=None):
    args = parse_args(argv)
    smi = phase_device()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
    if args.only:
        t0 = time.perf_counter()
        rec = new_phases(smi, args.only, args.ces_M, GP["batch_size"])
        rec["wall_s"] = time.perf_counter() - t0
        (OUT_DIR / f"chip_smoke_{'_'.join(args.only)}.json").write_text(
            json.dumps(dict(nvidia_smi=smi, torch=torch.__version__,
                            device=device, **rec), indent=1, default=str))
        print(smi)
        print(json.dumps({"ok": True, "device": device}))
        return
    build_s = phase_build()
    gmm_rows, gmm_err = phase_kernels()
    bwd_rows, bwd_err = phase_kernels_bwd()
    flash_rows, flash_err = phase_flash_kernels()
    bf16_rows, bf16_err = phase_flash_kernels_bf16()
    slice_rec, batch, curves = phase_slice()
    flash_slice_rec = phase_flash_slice(batch, curves)
    bf16_slice_rec, bf16_curves, model_c = phase_slice_bf16(batch, curves)
    bf16_flash_slice_rec = phase_flash_slice_bf16(batch, bf16_curves, model_c,
                                                  curves)
    del batch, curves, bf16_curves, model_c
    parity_err = phase_parity()
    train_rec = phase_train(smi)
    flash_train_rec = phase_train(smi, "flash train", FLASH_TRAIN_ARGS)
    bf16_train_rec = phase_train(smi, "bf16 train", BF16_TRAIN_ARGS)
    bf16_flash_train_rec = phase_train(smi, "bf16 flash train",
                                       BF16_TRAIN_ARGS + FLASH_TRAIN_ARGS)
    train_parity_err = phase_train_parity()
    flash_parity_err = phase_flash_train_parity()
    bf16_parity = phase_train_parity_bf16()
    bed_rec = phase_bed(smi)
    bed_witness = phase_bed_witness()
    loc_train_rec = phase_train_loc(smi)
    task_recs = new_phases(smi, NEW_PHASES, args.ces_M, GP_SMOKE_B)

    paths = {"eval": slice_rec, "train": train_rec,
             "flash_eval": flash_slice_rec, "flash_train": flash_train_rec,
             "eval_bf16": bf16_slice_rec, "train_bf16": bf16_train_rec,
             "flash_eval_bf16": bf16_flash_slice_rec,
             "flash_train_bf16": bf16_flash_train_rec, "bed": bed_rec,
             "train_loc": loc_train_rec, "gp": task_recs["gp"],
             "bench": task_recs["bench"],
             "train_continuous": task_recs["cont"]["reinforce"],
             "train_continuous_pathwise": task_recs["cont"]["pathwise"],
             "dad": task_recs["dad"], "trend": task_recs["trend"]}

    def record(name, replaces, row, err, source=None, dtype="float32",
               **extra):
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"aline_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "dtype": dtype, **extra,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": row["ms"], "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **{k: row[k] for k in ("fma_bound_ms", "tc_bound_ms",
                                       "dense_bound_ms") if k in row},
                "shape": row.get("shape", [row.get("B"), row.get("T")])}

    kernels = [
        record("gmm_head_fwd", "aline_tpu/ops/gmm_head_kernel.py:27",
               gmm_rows["pool"], gmm_err),
        # no Pallas kernel of its own: it lists the pairs that both flash
        # kernels walk
        record("flash_plan", None, flash_rows["eval"]["plan"], 0.0,
               serves=["flash_attn_fwd", "flash_attn_bwd"]),
        record("gmm_head_bwd", "aline_tpu/ops/gmm_head_kernel.py:41",
               bwd_rows["train targets"], bwd_err),
        record("flash_attn_fwd", "aline_tpu/ops/flash_attention.py:43",
               flash_rows["eval"]["fwd"], flash_err["fwd"]),
        record("flash_attn_bwd", "aline_tpu/ops/flash_attention.py:65",
               flash_rows["train"]["bwd"], flash_err["bwd"]),
        # the bf16 forms: the same sources' *_bf16 entry points
        record("flash_attn_fwd_bf16", "aline_tpu/ops/flash_attention.py:43",
               bf16_rows["eval"]["fwd"], bf16_err["fwd"],
               source="flash_attn_fwd", dtype="bfloat16"),
        record("flash_attn_bwd_bf16", "aline_tpu/ops/flash_attention.py:65",
               bf16_rows["train"]["bwd"], bf16_err["bwd"],
               source="flash_attn_bwd", dtype="bfloat16")]
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, torch=torch.__version__, build_s=build_s,
        gmm_head_fwd=gmm_rows, gmm_head_bwd=bwd_rows, flash=flash_rows,
        flash_bf16=bf16_rows, slice=slice_rec, flash_slice=flash_slice_rec,
        slice_bf16=bf16_slice_rec, flash_slice_bf16=bf16_flash_slice_rec,
        parity_max_abs=parity_err, train=train_rec,
        flash_train=flash_train_rec, train_bf16=bf16_train_rec,
        flash_train_bf16=bf16_flash_train_rec,
        train_parity_max_abs=train_parity_err,
        flash_train_parity_max_abs=flash_parity_err,
        train_parity_bf16=bf16_parity, bed=bed_rec,
        bed_witness=bed_witness, train_loc=loc_train_rec, **task_recs,
        kernels=kernels, device=device),
        indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
