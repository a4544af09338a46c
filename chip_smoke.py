#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aline_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result lines; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — builds every CUDA kernel from ``aline_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main paths' shapes, with timings.  Forward: rtol = atol
             = 1e-4 (float32 accuracy on both sides: TF32 is off in
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

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
import copy
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

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
    shapes = [(BATCH, N_QUERY + 1, "pool"), (BATCH, 102, "targets"),
              (200, 102, "train targets"), (3, 37, "ragged")]
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
              (3, 37, "ragged")]
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


def run_copy(name, dtype=None, attention_impl=None, fused_gmm=None):
    """A copy of the flagship's run directory (its config.json only, with
    the given changes) under ``OUT_DIR``, for ``load_model``."""
    run_dir = OUT_DIR / name
    run_dir.mkdir(parents=True, exist_ok=True)
    run_cfg = json.loads((RUN_DIR / "config.json").read_text())
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


def device_busy(fn):
    """(device busy ms, wall ms) of ``fn`` under ``torch.profiler``: the
    union of the kernels' intervals, and the host clock around the run
    (slowed by the profiler)."""
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
    return busy_us(kernels) / 1e3, wall * 1e3


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
                    max_ulps=None):
    """Along the reference's aline trajectory ``ref_idx`` [rows, T] over
    the first ``rows`` rows of ``batch``: every model of ``others``
    ({name: (model, its own idx [rows, T])}) is run on the reference's
    state at every step, its design scores and posterior means held to
    ``max_ulps`` of the reference's; and every row whose own choices leave
    the reference's must do so where the reference's bf16 design scores
    of the two candidates lie within BF16_TIE_ULPS.  With ``max_ulps``
    None both are only read.  Returns the readings per model."""
    from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
    b = init_ctx_idx(batch, min(int(batch.ctx_mask[0].sum()) + T_STEPS,
                                batch.n_points))
    ref_dev = next(ref_model.parameters()).device
    b = batch_rows(b, rows, ref_dev)
    ref_idx = ref_idx.cpu()
    res = {}
    for name, (_, idx) in others.items():
        differs, first = first_change(idx.cpu(), ref_idx)
        res[name] = dict(differs=differs, first=first, ulps=0.0, near=0,
                         n=0, gap=torch.zeros(rows, dtype=torch.int32))
    with torch.no_grad():
        for t in range(T_STEPS + 1):
            out_r, s_r = design_forward(ref_model, b)
            for name, (model, idx) in others.items():
                dev = next(model.parameters()).device
                out, s = design_forward(model, b.to(dev))
                r = res[name]
                for u in (bf16_ulps(s, s_r), bf16_ulps(
                        out.posterior_out.mixture_means,
                        out_r.posterior_out.mixture_means)):
                    r["ulps"] = max(r["ulps"], u.max().item())
                    r["near"] += int((u <= 1).sum())
                    r["n"] += u.numel()
                if t < T_STEPS:
                    here = r["differs"] & (r["first"] == t)
                    gap = score_gap_ulps(s_r.cpu(), ref_idx[:, t],
                                         idx.cpu()[:, t])
                    r["gap"] = torch.where(here, gap, r["gap"])
            if t == T_STEPS:
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
    busy, wall = device_busy(lambda: compare_strategies(
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


def main():
    smi = phase_device()
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

    paths = {"eval": slice_rec, "train": train_rec,
             "flash_eval": flash_slice_rec, "flash_train": flash_train_rec,
             "eval_bf16": bf16_slice_rec, "train_bf16": bf16_train_rec,
             "flash_eval_bf16": bf16_flash_slice_rec,
             "flash_train_bf16": bf16_flash_train_rec}

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
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
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
        train_parity_bf16=bf16_parity, kernels=kernels, device=device),
        indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
