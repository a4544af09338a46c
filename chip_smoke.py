#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aline_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result lines; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — builds every CUDA kernel from ``aline_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main paths' shapes, with timings.  Forward: rtol = atol
             = 1e-4 (only the float32 summation order differs, TF32 is
             off).  Backward: also against ``torch.autograd.grad`` of the
             two-einsum formula, within 1e-4 of each element plus 1e-4 of
             the gradient's largest element (the weight gradients sum up to
             40,200 rows, in per-block partials and then over blocks, where
             the plain version sums in another order), on inputs whose
             pre-activations are exact (``gmm_inputs(grid=True)``: else a
             pre-activation within rounding of 0 flips the relu mask
             between two summation orders); two calls on the same inputs
             must agree bitwise (no atomics).
4. slice   — the flagship GP-AL-1D eval (checkpoints/al1d_200k, weights
             from the committed npz): a B=100, n_query=2000 GP batch and
             the three-strategy T=30 active-learning rollout through
             ``compare_strategies``, with the kernel launch counts.
5. parity  — a small batch through the slice on the CPU (plain versions)
             and on the card (kernels): curves within 1e-4, same indices.
6. train   — the GP-AL-1D training recipe (B=200, n_query_init=200,
             T=30, f32, rollout_remat) from a fresh flax-equal init through
             ``Trainer``: 2 burning and 3 main epochs, with the launch
             counts of both kernels per epoch, the warm epoch time,
             rollouts/s and peak device memory.
7. train parity — one optimizer step from the flagship's params on the
             CPU (plain versions) and on the card (kernels): a B=4,
             n_query=16, T=5 batch with a fixed mask and the same Gumbel
             noise; same designs, the losses within 1e-4, the gradients
             within 1e-4 of each element plus 1e-4 of the largest, and the
             updated params within 1e-4 wherever the two devices' gradients
             agree to 1% (see ``phase_train_parity``).

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "checkpoints" / "al1d_200k"
OUT_DIR = ROOT / "chiprun_out"
TOL = 1e-4
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
T_STEPS, BATCH, N_QUERY = 30, 100, 2000
# the GP-AL-1D training recipe (bench.py, train.py's docstring)
TRAIN_ARGS = ["task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
              "task.n_query_init=200", "batch_size=200", "min_T=30", "T=30",
              "rollout_remat=true", "burning_epoch=2", "max_epoch=5",
              "checkpoint=0", "verbose=1000"]


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
        flops = 2 * B * T * C * (D * F + 3 * F)
        nbytes = 4 * sum(t.numel() for t in args) + 4 * got.numel()
        bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
        row = dict(
            B=B, T=T, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=time_ms(lambda: ghk.gmm_head_fwd(*args)),
            plain_ms=time_ms(lambda: ghk.gmm_head_fwd_plain(*args)),
            # the two-einsum formula, timed as the library yardstick
            library_ms=time_ms(lambda: torch.einsum(
                "btcf,cfo->btco", torch.relu(
                    torch.einsum("btd,cdf->btcf", z, w1) + b1), w2) + b2),
            bound_ms=bound_s * 1e3,
            bound_by=("operations" if flops / PEAK_F32_FLOPS
                      >= nbytes / PEAK_HBM_BYTES else "bytes"),
            flops=flops, bytes=nbytes)
        rows[what] = row
        log("kernels", f"gmm_head_fwd {what} B={B} T={T}: max abs err "
            f"{abs_err:.3e}, max rel err {rel_err:.3e}; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, two-einsum "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    return rows, worst


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
        flops = n * C * (6 * D * F + 12 * F)
        nbytes = 4 * (2 * n * D + n * 3 * C + 2 * (w1.numel() + b1.numel()
                                                   + w2.numel()) + 3 * C)
        bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
        row = dict(
            B=B, T=T, max_abs_err=abs_err, errors=errs,
            ms=time_ms(lambda: ghk.gmm_head_bwd(z, w1, b1, w2, g)),
            plain_ms=time_ms(lambda: ghk.gmm_head_bwd_plain(z, w1, b1, w2,
                                                            g)),
            # the backward of the two-einsum formula by autograd
            library_ms=time_ms(lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True)),
            bound_ms=bound_s * 1e3,
            bound_by=("operations" if flops / PEAK_F32_FLOPS
                      >= nbytes / PEAK_HBM_BYTES else "bytes"),
            flops=flops, bytes=nbytes)
        rows[what] = row
        log("kernels", f"gmm_head_bwd {what} B={B} T={T}: max abs err "
            f"{abs_err:.3e} (vs plain and autograd), bitwise repeatable; "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"autograd {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows, worst


def reset_launches():
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    for name in ghk.LAUNCHES:
        ghk.LAUNCHES[name] = 0


def phase_slice():
    from aline_tpu_torch.eval.al_curves import compare_strategies
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
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

    reset_launches()
    t0 = time.perf_counter()
    curves = compare_strategies(model, batch, T_STEPS, gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ghk.LAUNCHES)

    want = {"gmm_head_fwd": 2 * (T_STEPS + 1) * len(curves),
            "gmm_head_bwd": 0}
    if launches != want:
        raise AssertionError(f"kernel launches in the slice {launches}, "
                             f"expected {want}")
    n_ctx0 = task.n_context_init
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
        log("slice", f"{name}: mean log_prob step 0 {ll0:.4f}, step "
            f"{T_STEPS} {llT:.4f}; final rmse {result[name]['rmse_final']:.4f}")
    if not result["aline"]["ll_final"] > result["aline"]["ll_step0"]:
        raise AssertionError("aline's mean log-prob did not improve")
    log("slice", f"B={BATCH} n_query={N_QUERY} T={T_STEPS}: GP batch "
        f"{sample_s:.3f} s, three rollouts {wall_s:.3f} s, launches "
        f"{launches}")
    return dict(strategies=result, sample_s=sample_s, rollouts_s=wall_s,
                launches=launches)


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


def phase_train(smi):
    from aline_tpu_torch.config import parse_overrides
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    from aline_tpu_torch.train.loop import Trainer

    out_dir = OUT_DIR / "train_smoke"
    cfg = parse_overrides(TRAIN_ARGS + [f"output_dir={out_dir}"])
    trainer = Trainer(cfg, device="cuda")
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    trainer._ensure_phase("burning")
    burning_opt = trainer.optimizer
    per_epoch, totals = [], {name: 0 for name in ghk.LAUNCHES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for epoch in range(cfg.max_epoch):
        reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_epoch(epoch)
        m = {k: float(v) for k, v in m.items()}           # sync
        seconds = time.perf_counter() - t0
        launches = dict(ghk.LAUNCHES)
        T = int(m["T"])
        want = {"gmm_head_fwd": T * (2 if cfg.rollout_remat else 1),
                "gmm_head_bwd": T}
        if launches != want:
            raise AssertionError(f"epoch {epoch}: launches {launches}, "
                                 f"expected {want} (T={T}, rollout_remat="
                                 f"{cfg.rollout_remat})")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"epoch {epoch}: non-finite metrics {m}")
        for name in totals:
            totals[name] += launches[name]
        per_epoch.append(dict(epoch=epoch, phase=trainer.phase, s=seconds,
                              **m))
        log("train", f"epoch {epoch} ({trainer.phase}): {seconds * 1e3:.1f} "
            f"ms, loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, "
            f"launches {launches}")
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
    log("train", f"B={cfg.batch_size} n_query={cfg.task.n_query_init} "
        f"T={cfg.T} f32: warm epoch {warm_ms:.1f} ms, {rollouts_s:.1f} "
        f"rollouts/s, peak memory {peak / 2**30:.3f} GiB ({smi})")
    return dict(epochs=per_epoch, warm_ms=warm_ms, rollouts_s=rollouts_s,
                peak_bytes=peak, launches=totals)


def phase_train_parity():
    from aline_tpu_torch.models.heads import gumbel_noise
    from aline_tpu_torch.ops.target_mask import target_weight_vectors
    from aline_tpu_torch.tasks import build_task, init_ctx_idx
    from aline_tpu_torch.train.loop import train_step
    from aline_tpu_torch.train.optimizer import build_optimizer
    from aline_tpu_torch.train.rollout import rollout
    from aline_tpu_torch.utils.serialization import (
        AL1D_200K_PARAMS, load_model)

    T = 5
    cfg, model_cpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cpu")
    _, model_gpu = load_model(str(RUN_DIR), AL1D_200K_PARAMS, "cuda")
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
    sel = tuple(range(task.n_target_data))
    runs, idx = {}, {}
    for name, model, dev in (("cpu", model_cpu, "cpu"),
                             ("gpu", model_gpu, "cuda")):
        with torch.no_grad():
            idx[name] = rollout(model, batch.to(dev), T, w_q.to(dev),
                                w_p.to(dev), noise.to(dev),
                                sel_targets=sel).idx.cpu()
        opt, sched = build_optimizer(cfg, model, "main")
        m = train_step(model, opt, sched, batch.to(dev), T, w_q.to(dev),
                       w_p.to(dev), cfg.alpha, noise.to(dev),
                       gamma=cfg.gamma, sel_targets=sel)
        runs[name] = (m, {n: p.detach().cpu() for n, p in
                          model.named_parameters()},
                      {n: p.grad.cpu() for n, p in model.named_parameters()})
    (m_c, p_c, g_c), (m_g, p_g, g_g) = runs["cpu"], runs["gpu"]
    if not torch.equal(idx["cpu"], idx["gpu"]):
        raise AssertionError("train step: CPU and card drew different "
                             "designs from the same noise")
    worst = 0.0
    for k in ("loss", "design_loss", "predict_loss"):
        abs_err, _, ok = close(m_g[k].cpu(), m_c[k])
        if not ok:
            raise AssertionError(f"train step {k}: CPU {m_c[k]:.6f}, card "
                                 f"{m_g[k]:.6f}")
        worst = max(worst, abs_err)
    # gradients: within 1e-4 of each element plus 1e-4 of the model's
    # largest gradient element (sums over the batch, rollout and layers in
    # another order on each device)
    scale = max(g.abs().max() for g in g_c.values())
    for n, g in g_c.items():
        err = (g_g[n] - g).abs()
        if not bool((err <= TOL * g.abs() + TOL * scale).all()):
            raise AssertionError(f"train step: grad of {n} differs between "
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
            raise AssertionError(f"train step: {n} differs between CPU and "
                                 f"card by {err.max():.3e}")
        if resolved.any():
            worst = max(worst, err[resolved].max().item())
        resolved_n += int(resolved.sum())
        total_n += resolved.numel()
    log("train parity", f"one step from the flagship params, B=4 "
        f"n_query=16 T={T}: loss CPU {float(m_c['loss']):.6f}, card "
        f"{float(m_g['loss']):.6f}, same designs; grads within tolerance; updated "
        f"params within {worst:.3e} on the {resolved_n} of {total_n} "
        f"entries whose gradient the two devices resolve")
    return worst


def main():
    smi = phase_device()
    build_s = phase_build()
    gmm_rows, gmm_err = phase_kernels()
    bwd_rows, bwd_err = phase_kernels_bwd()
    slice_rec = phase_slice()
    parity_err = phase_parity()
    train_rec = phase_train(smi)
    train_parity_err = phase_train_parity()

    def record(name, line, row, err):
        by_path = {"eval": slice_rec["launches"][name],
                   "train": train_rec["launches"][name]}
        return {"name": name, "route": "cuda",
                "source": f"aline_tpu_torch/csrc/{name}.cu",
                "replaces": f"aline_tpu/ops/gmm_head_kernel.py:{line}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": [row["B"],
                                                          row["T"]]}

    kernels = [record("gmm_head_fwd", 27, gmm_rows["pool"], gmm_err),
               record("gmm_head_bwd", 41, bwd_rows["train targets"],
                      bwd_err)]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, torch=torch.__version__, build_s=build_s,
        gmm_head_fwd=gmm_rows, gmm_head_bwd=bwd_rows, slice=slice_rec,
        parity_max_abs=parity_err, train=train_rec,
        train_parity_max_abs=train_parity_err, kernels=kernels,
        device=device), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
