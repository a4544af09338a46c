"""Bayesian experimental design of CES preferences, one batch a request:
each unit draws a batch of CES experiments (``gen_ces.py``), rolls them
out greedily (``get_traces``) and bounds them step by step
(``compute_eig_from_history``, the generic fold: the task's
log-likelihood over [Lc, B, Th], its running sum, ``lse_update``), as
``eval_boed`` does for each batch.  End to end: ``bed_rollouts_per_s``,
rows of the batches completed in the window over the window.

Under ``--trace 1`` the program's own tracing is on for the window only
(off in the profiled slice after it, whose trace would count the spans'
annotations as device work): the stream seconds of its spans
``eig.chunk``, ``eig.loglik`` and ``eig.lse`` go to ``run.spans`` as
``prog.<span>``, its counter ``eig.terms`` to ``run.counts["eig_terms"]``.
A program without them leaves them out, and their readers read None.
"""
from __future__ import annotations

import math
import random
import sys
import time

import torch

from portbench import gen, program
from portbench.counts import aline_flops, ces_fold
from portbench.gen_ces import ces_batch
from portbench.harness import load_peaks
from portbench.reference.ces import ces_bounds
from portbench.reference.eig import derive_seed
from portbench.reference.model import (Inputs, Rounder, load_params,
                                       precision)
from portbench.reference.rollouts import control_rollout, judge_rollout
from portbench.trace import traced

SPANS = ("eig.chunk", "eig.loglik", "eig.lse")


def _inputs(dev, seed: int, k: int, tr: dict, task: dict):
    return ces_batch(gen.generator(dev, seed, 0, k), tr["batch_size"],
                     tr["n_query"], task)


def _program_batch(d, task):
    x, theta = d["x"], d["theta"]
    return program.batch(x, d["y"], x.new_zeros(x.shape[0], 0, x.shape[-1]),
                         theta[..., None], theta, task["n_context_init"])


def _program_spans():
    """The program's spans closed so far: the stream seconds of those
    named in ``SPANS`` by name (``prog.<name>``), and the sum of their
    ``eig.terms`` counts (0 where the program has no such counter)."""
    from aline_tpu_torch.utils import metrics
    out, terms = {}, 0
    for s in metrics.collect():
        if s.name in SPANS:
            t = s.stream_s()
            if t is None:       # no card: the host's time
                t = (s.end_ns - s.start_ns) / 1e9
            out.setdefault("prog." + s.name, []).append(t)
        terms += (getattr(s, "counts", None) or {}).get("eig.terms", 0)
    return out, terms


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
    inputs = [_inputs(dev, ctx.seed, k, tr, task)
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
    if ctx.trace:
        from aline_tpu_torch.utils.metrics import set_tracing
        _program_spans()                # drop what the set-up left
        set_tracing(True)
    done = []
    t0 = time.perf_counter()
    while True:
        with rec.span("unit", ctx.sync):
            done.append((k, call(k)))
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    if ctx.trace:
        set_tracing(False)
        spans, terms = _program_spans()
        rec.spans.update(spans)
        if terms:
            rec.counts["eig_terms"] = terms
    rec.units, rec.window_s = len(done), window
    peaks = load_peaks()
    Th = n_ctx + T
    fold_least = ces_fold.least_s(L, B, Th, peaks)
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
    final = torch.cat([res["pce"][:, -1] for _, res in done])
    se = float(final.std()) / math.sqrt(final.numel()) \
        if final.numel() > 1 else float("nan")
    print(f"bed_ces: final-step sPCE {float(final.mean())!r} ± {se!r} "
          f"(SE) over the window's {final.numel()} rows", file=sys.stderr)
    readings = check(ctx, done, inputs, task)
    return dict(end_to_end={"bed_rollouts_per_s": len(done) * B / window},
                readings=readings, attempted=len(done), failed=0,
                memory_peak_bytes=peak, device_kind=kind)


def _sample(seed: int, done, tr: dict, B: int):
    """The check's sample of units and, in each, of rows."""
    rng = random.Random(derive_seed(seed, 3))
    for k, res in rng.sample(done, min(tr["check_units"], len(done))):
        yield k, res, sorted(rng.sample(range(B), min(tr["check_rows"], B)))


def _reference_inputs(x, y, n_theta: int):
    return Inputs(x, y, x.new_zeros(x.shape[0], 0, x.shape[-1]), n_theta,
                  torch.ones(n_theta, dtype=torch.bool, device=x.device))


def _ctx0(x, n_ctx: int):
    c = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    c[:, :n_ctx] = True
    return c


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
    out = dict(design_gap=0.0, history_mismatch=0, pce_gap=0.0, nmc_gap=0.0)
    for k, res, rows in _sample(ctx.seed, done, tr, tr["batch_size"]):
        d = inputs[k % len(inputs)]
        B = d["x"].shape[0]
        rows = torch.tensor(rows, device=dev)
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
            inp = _reference_inputs(x[r], y[r], task["n_target_theta"])
            g = judge_rollout(P, inp, _ctx0(inp.x, n_ctx), None, None, T,
                              idx[r], "aline", prec, arch, curves=False)
            out["design_gap"] = max(out["design_gap"], float(g["gap"].max()))
        pce, nmc = ces_bounds(d["theta"][rows], xs, ys, tr["L"],
                              derive_seed(ctx.seed, 2, k), tr["L_chunk"],
                              task, bounds_r, B_draw=B, rows=rows)
        out["pce_gap"] = max(out["pce_gap"], float(
            (pce.cpu() - res["pce"][rows.cpu()]).abs().max()))
        out["nmc_gap"] = max(out["nmc_gap"], float(
            (nmc.cpu() - res["nmc"][rows.cpu()]).abs().max()))
    return out


def control(cf, tr, dev, seed) -> dict:
    """The reference one precision below the configuration's in the
    program's place, judged as a run judges the program on the inputs of
    a run of that seed (its first batch): the designs that the lower
    precision puts first, under the reference, and the bounds of the
    reference's own rollouts in the lower precision against the
    configuration's."""
    task = cf["run"]["task"]
    P = load_params(program.weights_path(cf), dev)
    ref, ctl = precision(cf["precision"]), precision(cf["precision"], True)
    arch = program.arch(cf)
    n_ctx, T, B = task["n_context_init"], tr["T"], tr["batch_size"]
    d = _inputs(dev, seed, 0, tr, task)
    rng = random.Random(derive_seed(seed, 3))
    rows = torch.tensor(sorted(rng.sample(range(B), tr["check_rows"])),
                        device=dev)
    out = dict(design_gap=0.0, history_mismatch=0, pce_gap=0.0,
               nmc_gap=0.0)
    idx = []
    for a in range(0, len(rows), tr["reference_block_rows"]):
        r = rows[a:a + tr["reference_block_rows"]]
        inp = _reference_inputs(d["x"][r], d["y"][r], task["n_target_theta"])
        res = control_rollout(P, inp, _ctx0(inp.x, n_ctx), None, None, T,
                              "aline", ref, ctl, arch, None, curves=False)
        out["design_gap"] = max(out["design_gap"], float(res["gap"].max()))
        idx.append(res["idx"])
    idx = torch.cat(idx)
    x, y = d["x"][rows], d["y"][rows]
    xs = torch.cat([x[:, :n_ctx], torch.gather(
        x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))], dim=1)
    ys = torch.cat([y[:, :n_ctx], torch.gather(y, 1, idx[..., None])], 1)
    s = derive_seed(seed, 2, 0)
    lower = {"float32": "bfloat16"}[cf["precision"]["bounds"]]
    bounds = [ces_bounds(d["theta"][rows], xs, ys, tr["L"], s,
                         tr["L_chunk"], task, Rounder(p), B_draw=B,
                         rows=rows)
              for p in (cf["precision"]["bounds"], lower)]
    out["pce_gap"] = float((bounds[0][0] - bounds[1][0]).abs().max())
    out["nmc_gap"] = float((bounds[0][1] - bounds[1][1]).abs().max())
    return out
