"""Bayesian experimental design, one batch a request: each unit draws a
batch of location-finding experiments, rolls them out greedily
(``get_traces``) and bounds them step by step
(``compute_eig_from_history``), as ``eval_boed`` does for each batch.
End to end: ``bed_rollouts_per_s``, rows of the batches completed in the
window over the window."""
from __future__ import annotations

import random
import time

import torch

from portbench import gen, program
from portbench.counts import aline_flops, eig_fold
from portbench.harness import load_peaks
from portbench.reference.eig import derive_seed, loc_bounds
from portbench.reference.model import (Inputs, Rounder, load_params,
                                       precision)
from portbench.reference.rollouts import judge_rollout
from portbench.trace import traced


def _program_batch(d, task):
    B, K, D = d["theta"].shape
    x = d["x"]
    return program.batch(x, d["y"], x.new_zeros(B, 0, D),
                         d["theta"].reshape(B, K * D, 1), d["theta"],
                         task["n_context_init"])


def run(ctx):
    from aline_tpu_torch.eval.eig import compute_eig_from_history
    from aline_tpu_torch.eval.traces import get_traces
    from aline_tpu_torch.tasks import build_task
    cf, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.run
    task = cf["run"]["task"]
    n_ctx = task["n_context_init"]
    B, nq, T, L = tr["batch_size"], tr["n_query"], tr["T"], tr["L"]
    pcfg, model = program.model(cf, dev)
    ptask = build_task(pcfg.task)
    inputs = [gen.loc_batch(gen.generator(dev, ctx.seed, 0, k), B, nq, task)
              for k in range(tr["n_inputs"])]

    def call(k):
        d = inputs[k % len(inputs)]
        with rec.span("traces", ctx.sync):
            th0, xs, ys = get_traces(model, ptask, _program_batch(d, task),
                                     T, pcfg.time_token)
        with rec.span("eig_fold", ctx.sync):
            pce, nmc = compute_eig_from_history(
                ptask, th0, xs, ys, L, derive_seed(ctx.seed, 2, k),
                L_chunk=tr["L_chunk"], stepwise=True)
        return dict(xs=xs.cpu(), ys=ys.cpu(), pce=pce.cpu(), nmc=nmc.cpu())

    k = 0
    for _ in range(tr["warmup_units"]):
        call(k)
        k += 1
    rec.spans.clear()
    ctx.open_window()
    done = []
    t0 = time.perf_counter()
    while True:
        with rec.span("unit", ctx.sync):
            done.append((k, call(k)))
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    rec.units, rec.window_s = len(done), window
    peaks = load_peaks()
    Th = n_ctx + T
    fold_least = eig_fold.loc_least_s(L, B, Th, task["K"], task["dim_x"],
                                      peaks)
    # the traces' T forwards, the pool's posterior not read
    flops = aline_flops.rollout(
        aline_flops.sizes_of(cf["run"]), B, n_ctx + nq, n_ctx, 0,
        task["n_target_theta"], task["n_target_theta"], T, final=False)
    rec.counts.update(model_flops=flops * len(done),
                      peak_flops=peaks["bf16_flops"],
                      other_least_s=fold_least * len(done),
                      eig_fold_least_s=fold_least)
    if ctx.trace:
        spans = {n: list(v) for n, v in rec.spans.items()}
        rec.trace = {}
        with traced(rec.trace):
            for _ in range(tr["trace_units"]):
                call(k)
                k += 1
        rec.trace_units = tr["trace_units"]
        rec.spans = spans
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check(ctx, done, inputs, task)
    return dict(end_to_end={"bed_rollouts_per_s": len(done) * B / window},
                readings=readings, attempted=len(done), failed=0,
                memory_peak_bytes=peak, device_kind=kind)


def check(ctx, done, inputs, task) -> dict:
    """Judge a sample of the window's batches, on a sample of rows: the
    history is the batch's own points (``history_mismatch``: rows whose
    designs or outcomes are not candidates of the batch, or not in the
    order the program chose them), each design the reference's greedy
    choice (``design_gap``), the bounds the reference's (``pce_gap``,
    ``nmc_gap``)."""
    cf, tr, dev = ctx.config, ctx.traffic, ctx.device
    n_ctx, T = task["n_context_init"], tr["T"]
    P = load_params(program.weights_path(cf), dev)
    prec = precision(cf["precision"])
    bounds_r = Rounder(cf["precision"]["bounds"])
    arch = program.arch(cf)
    rng = random.Random(derive_seed(ctx.seed, 3))
    out = dict(design_gap=0.0, history_mismatch=0, pce_gap=0.0, nmc_gap=0.0)
    for k, res in rng.sample(done, min(tr["check_units"], len(done))):
        d = inputs[k % len(inputs)]
        B = d["x"].shape[0]
        rows = torch.tensor(sorted(rng.sample(range(B),
                                              min(tr["check_rows"], B))),
                            device=dev)
        xs, ys = res["xs"].to(dev)[rows], res["ys"].to(dev)[rows]
        x, y = d["x"][rows], d["y"][rows]
        # the program's choices, read back from its designs
        hit = (xs[:, n_ctx:, None, :] == x[:, None, :, :]).all(-1)
        idx = hit.float().argmax(-1)                          # [b, T]
        got_y = torch.gather(y[..., 0], 1, idx)
        bad = ((hit.sum(-1) != 1).any(-1)
               | (got_y != ys[:, n_ctx:, 0]).any(-1)
               | (xs[:, :n_ctx] != x[:, :n_ctx]).any((-1, -2)))
        out["history_mismatch"] += int(bad.sum())
        for a in range(0, len(rows), tr["reference_block_rows"]):
            r = slice(a, a + tr["reference_block_rows"])
            n_theta = task["K"] * task["dim_x"]
            inp = Inputs(x[r], y[r], x.new_zeros(x[r].shape[0], 0,
                                                  x.shape[-1]),
                         n_theta, torch.ones(n_theta, dtype=torch.bool,
                                             device=dev))
            ctx0 = torch.zeros(inp.x.shape[:2], dtype=torch.bool, device=dev)
            ctx0[:, :n_ctx] = True
            g = judge_rollout(P, inp, ctx0, None, None, T, idx[r], "aline",
                              prec, arch, curves=False)
            out["design_gap"] = max(out["design_gap"], float(g["gap"].max()))
        theta0 = d["theta"][rows]
        pce, nmc = loc_bounds(theta0, xs, ys, tr["L"],
                              derive_seed(ctx.seed, 2, k), tr["L_chunk"],
                              task, bounds_r, B_draw=B, rows=rows)
        out["pce_gap"] = max(out["pce_gap"], float(
            (pce.cpu() - res["pce"][rows.cpu()]).abs().max()))
        out["nmc_gap"] = max(out["nmc_gap"], float(
            (nmc.cpu() - res["nmc"][rows.cpu()]).abs().max()))
    return out
