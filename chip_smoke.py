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
             1e-3); the compact path on the CPU is held to the same and
             reported beside flash as the witness of how many rows leave
             a tie by rounding alone.
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
7b. flash + time-token step parity — the same check for a fresh model
             from the seed with ``encoder.with_time_token=true
             time_token=true encoder.attention_impl=flash``.

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
# on the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
T_STEPS, BATCH, N_QUERY = 30, 100, 2000
# the GP-AL-1D training recipe (bench.py, train.py's docstring)
TRAIN_ARGS = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
              "task.n_query_init=200", "batch_size=200", "min_T=30", "T=30",
              "rollout_remat=true", "burning_epoch=2", "max_epoch=5",
              "checkpoint=0", "verbose=1000"]
FLASH_TRAIN_ARGS = ["encoder.attention_impl=flash", "max_epoch=4"]
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


def gmm_bound(mma_flops, other_flops, nbytes):
    """The least time of a GMM kernel's two forms: every FLOP on float32
    FMAs, or the D x F products (``mma_flops``) as 3xTF32 on the tensor
    cores and the rest on FMAs; each against the bytes."""
    fma = bound(mma_flops + other_flops, nbytes)
    t_tc = 3 * mma_flops / PEAK_TF32_FLOPS + other_flops / PEAK_F32_FLOPS
    tc = max(t_tc, nbytes / PEAK_HBM_BYTES) * 1e3
    best = (dict(bound_ms=tc, bound_by="operations" if t_tc >= nbytes /
                 PEAK_HBM_BYTES else "bytes")
            if tc <= fma["bound_ms"] else
            dict(bound_ms=fma["bound_ms"], bound_by=fma["bound_by"]))
    return dict(best, fma_bound_ms=fma["bound_ms"], tc_bound_ms=tc,
                flops=mma_flops + other_flops, bytes=nbytes)


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
    counts = {n: c for n, c in launches().items() if n.startswith("flash")}
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
    flash = cfg.encoder.attention_impl == "flash"
    want = {"gmm_head_fwd": 2 * forwards, "gmm_head_bwd": 0,
            "flash_plan": forwards if flash else 0,
            "flash_attn_fwd": cfg.encoder.num_layers * forwards if flash
            else 0, "flash_attn_bwd": 0}
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


def phase_slice():
    from aline_tpu_torch.tasks import build_task
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    cfg, model = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cuda")
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
    on the same rows, whose rows that leave the card's trajectory must do
    so at ties too.  Both final mean log-prob differences are reported: a
    row that leaves a tie the other way follows another trajectory."""
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    from aline_tpu_torch.tasks.base import init_ctx_idx, select_design
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    run_dir = OUT_DIR / "flash_run"
    run_dir.mkdir(parents=True, exist_ok=True)
    run_cfg = json.loads((RUN_DIR / "config.json").read_text())
    run_cfg["encoder"]["attention_impl"] = "flash"
    (run_dir / "config.json").write_text(json.dumps(run_cfg, indent=2))
    cfg, model = load_model(str(run_dir), AL1D_200K_PARAMS, "cuda")
    if cfg.encoder.attention_impl != "flash":
        raise AssertionError("the run config did not select flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, curves = run_slice("flash slice", cfg, model, batch, gen)

    _, model_c = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cuda")
    _, model_cpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    batch_cpu = batch.to("cpu")
    t0 = time.perf_counter()
    witness = al_rollout_curves(model_cpu, batch_cpu, T_STEPS,
                                strategy="aline")
    witness_s = time.perf_counter() - t0
    ref = compact["aline"]
    runs = {"flash": {k: v.cpu() for k, v in curves["aline"].items()},
            "compact CPU": witness}
    ref_idx = ref["idx"].cpu()
    for run in runs.values():
        run["differs"], run["first"] = first_change(run["idx"], ref_idx)
        run["gap"] = torch.zeros(BATCH)

    b = init_ctx_idx(batch, min(int(batch.ctx_mask[0].sum()) + T_STEPS,
                                batch.n_points))
    rows = torch.arange(BATCH)
    err = {"flash vs compact": 0.0, "compact CPU vs card": 0.0}
    with torch.no_grad():
        for t in range(T_STEPS + 1):
            out_f, out_c = model(b), model_c(b)
            out_h = model_cpu(b.to("cpu").replace(
                **{f: getattr(b, f)[:CHECK_ROWS].cpu() for f in (
                    "x", "y", "ctx_mask", "target_x", "target_all", "theta",
                    "ctx_idx")}))
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
                here = run["differs"] & (run["first"] == t)
                gap = lp[rows, ref_idx[:, t]] - lp[rows, run["idx"][:, t]]
                run["gap"] = torch.where(here, gap, run["gap"])
            b, _, _ = select_design(b, ref["idx"][:, t])
    log("flash slice", f"along the compact path's aline trajectory, design "
        f"probs and posterior means: flash vs compact (card, {BATCH} rows) "
        f"within {err['flash vs compact']:.3e}; compact on the CPU vs on "
        f"the card ({CHECK_ROWS} rows) within "
        f"{err['compact CPU vs card']:.3e}")
    summary = {}
    ref_final = ref["log_prob"][:, -1].mean().item()
    for name, run in runs.items():
        same = ~run["differs"]
        summary[name] = dict(
            rows_differing=int(run["differs"].sum()),
            max_tie_gap=run["gap"].max().item(),
            same_rows_curve_max_abs=(
                (run["log_prob"] - ref["log_prob"].cpu()).abs()[same].max()
                .item() if same.any() else 0.0),
            final_mean_log_prob_diff=abs(
                run["log_prob"][:, -1].mean().item() - ref_final))
        r = summary[name]
        log("flash slice", f"{name} against compact on the card, same "
            f"batch: {r['rows_differing']} of {BATCH} rows chose "
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

    cfg, model_cpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    _, model_gpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cuda")
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
    flash = cfg.encoder.attention_impl == "flash"
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
        layers = cfg.encoder.num_layers if flash else 0
        want = {"gmm_head_fwd": fwd, "gmm_head_bwd": T,
                "flash_plan": fwd if flash else 0,
                "flash_attn_fwd": layers * fwd, "flash_attn_bwd": layers * T}
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
        f"T={cfg.T} f32 attention_impl={cfg.encoder.attention_impl}: warm "
        f"epoch {warm_ms:.1f} ms, {rollouts_s:.1f} "
        f"rollouts/s, peak memory {peak / 2**30:.3f} GiB ({smi})")
    return dict(epochs=per_epoch, warm_ms=warm_ms, rollouts_s=rollouts_s,
                peak_bytes=peak, launches=totals)


def train_step_parity(label, cfg, model_cpu, *, time_token=False):
    """One optimizer step of ``model_cpu`` on the CPU (plain versions)
    and of a copy on the card (kernels), from the same B=4, n_query=16,
    T=5 batch with the data mask and the same Gumbel noise."""
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
    (m_c, p_c, g_c), (m_g, p_g, g_g) = runs["cpu"], runs["gpu"]
    if not torch.equal(idx["cpu"], idx["gpu"]):
        raise AssertionError(f"{label}: CPU and card drew different designs "
                             f"from the same noise")
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
    return worst


def phase_train_parity():
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)
    cfg, model = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    return train_step_parity("train parity", cfg, model)


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
                             time_token=True)


def main():
    smi = phase_device()
    build_s = phase_build()
    gmm_rows, gmm_err = phase_kernels()
    bwd_rows, bwd_err = phase_kernels_bwd()
    flash_rows, flash_err = phase_flash_kernels()
    slice_rec, batch, curves = phase_slice()
    flash_slice_rec = phase_flash_slice(batch, curves)
    del batch, curves
    parity_err = phase_parity()
    train_rec = phase_train(smi)
    flash_train_rec = phase_train(smi, "flash train", FLASH_TRAIN_ARGS)
    train_parity_err = phase_train_parity()
    flash_parity_err = phase_flash_train_parity()

    paths = {"eval": slice_rec, "train": train_rec,
             "flash_eval": flash_slice_rec, "flash_train": flash_train_rec}

    def record(name, replaces, row, err, **extra):
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"aline_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, **extra,
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
               flash_rows["train"]["bwd"], flash_err["bwd"])]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, torch=torch.__version__, build_s=build_s,
        gmm_head_fwd=gmm_rows, gmm_head_bwd=bwd_rows, flash=flash_rows,
        slice=slice_rec, flash_slice=flash_slice_rec,
        parity_max_abs=parity_err, train=train_rec,
        flash_train=flash_train_rec, train_parity_max_abs=train_parity_err,
        flash_train_parity_max_abs=flash_parity_err, kernels=kernels,
        device=device), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
