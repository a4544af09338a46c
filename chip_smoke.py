#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aline_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result lines; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — builds every CUDA kernel from ``aline_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main path's shapes (rtol = atol = 1e-4: only the float32
             summation order differs, TF32 is off), with timings.
4. slice   — the flagship GP-AL-1D run (checkpoints/al1d_200k, weights from
             the committed npz): a B=100, n_query=2000 GP batch and the
             three-strategy T=30 active-learning rollout through
             ``compare_strategies``, with the kernel launch counts.
5. parity  — a small batch through the slice on the CPU (plain versions)
             and on the card (kernels): curves within 1e-4, same indices.

The line before the last is a JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
import json
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


def gmm_inputs(B, T, seed, D=32, F=128, C=10):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    return (randn(B, T, D), randn(C, D, F, std=D ** -0.5),
            randn(C, F, std=0.1), randn(C, F, 3, std=F ** -0.5),
            randn(C, 3, std=0.1))


def phase_kernels():
    from aline_tpu_torch.ops import gmm_head_kernel as ghk
    shapes = [(BATCH, N_QUERY + 1, "pool"), (BATCH, 102, "targets"),
              (3, 37, "ragged")]
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

    ghk.LAUNCHES = 0
    t0 = time.perf_counter()
    curves = compare_strategies(model, batch, T_STEPS, gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ghk.LAUNCHES

    want = 2 * (T_STEPS + 1) * len(curves)
    if launches != want:
        raise AssertionError(f"gmm_head_fwd launched {launches} times in "
                             f"the slice, expected {want}")
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
        f"{sample_s:.3f} s, three rollouts {wall_s:.3f} s, gmm_head_fwd "
        f"launches {launches}")
    return dict(strategies=result, sample_s=sample_s, rollouts_s=wall_s,
                launches={"gmm_head_fwd": launches})


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


def main():
    smi = phase_device()
    build_s = phase_build()
    gmm_rows, gmm_err = phase_kernels()
    slice_rec = phase_slice()
    parity_err = phase_parity()

    pool = gmm_rows["pool"]
    kernels = [{
        "name": "gmm_head_fwd", "route": "cuda",
        "source": "aline_tpu_torch/csrc/gmm_head_fwd.cu",
        "replaces": "aline_tpu/ops/gmm_head_kernel.py:27",
        "launches": slice_rec["launches"]["gmm_head_fwd"],
        "max_abs_err": gmm_err, "ms": pool["ms"],
        "plain_ms": pool["plain_ms"], "bound_ms": pool["bound_ms"],
        "bound_by": pool["bound_by"], "library_ms": pool["library_ms"],
    }]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, torch=torch.__version__, build_s=build_s,
        gmm_head_fwd=gmm_rows, slice=slice_rec, parity_max_abs=parity_err,
        kernels=kernels, device=device), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
