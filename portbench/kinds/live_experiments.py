"""Live experiments, one at a time: each unit is one GP experiment
(batch of 1) rolled out by ``al_rollout_curves`` under the policy.  Its
GP draw is made before its clock starts; the clock stops when its curves
and designs are on the host.  End to end: ``experiment_ms_p95``, the
95th percentile of the experiments' times in the window."""
from __future__ import annotations

import random
import time

import torch

from portbench import al, gen, program
from portbench.counts import aline_flops
from portbench.harness import load_peaks, quantile
from portbench.reference.eig import derive_seed
from portbench.trace import traced


def run(ctx):
    from aline_tpu_torch.eval.al_curves import al_rollout_curves
    cf, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.run
    task = cf["run"]["task"]
    n_ctx = task["n_context_init"]
    nq, T, strategy = tr["n_query"], tr["T"], tr["strategy"]
    if tr["batch_size"] != 1:
        raise ValueError("a live experiment is one rollout")
    pcfg, model = program.model(cf, dev)
    pool = gen.gp_batch(gen.generator(dev, ctx.seed, 0), tr["n_inputs"], nq,
                        task)

    def call(k):
        b = al.program_batch(pool, n_ctx, slice(k % tr["n_inputs"],
                                                k % tr["n_inputs"] + 1))
        ctx.sync()
        t0 = time.perf_counter()
        o = al_rollout_curves(model, b, T, strategy=strategy,
                              time_token=pcfg.time_token)
        o = {n: v.cpu() for n, v in o.items()}
        return time.perf_counter() - t0, o

    k = 0
    for _ in range(tr["warmup_units"]):
        call(k)
        k += 1
    ctx.open_window()
    done = []
    t0 = time.perf_counter()
    while True:
        dt, o = call(k)
        rec.spans.setdefault("unit", []).append(dt)
        done.append((k, dt, o))
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    rec.units, rec.window_s = len(done), time.perf_counter() - t0
    sizes = aline_flops.sizes_of(cf["run"])
    rec.counts.update(
        model_flops=len(done) * aline_flops.rollout(
            sizes, 1, n_ctx + nq, n_ctx, task["n_target_data"],
            task["n_target_theta"], task["n_target_data"]
            + task["n_target_theta"], T, final=True),
        peak_flops=load_peaks()["bf16_flops"])
    if ctx.trace:
        rec.trace = {}
        with traced(rec.trace):
            for _ in range(tr["trace_units"]):
                call(k)
                k += 1
        rec.trace_units = tr["trace_units"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rng = random.Random(derive_seed(ctx.seed, 3))
    picked = rng.sample(done, min(tr["check_units"], len(done)))
    slowest = max(done, key=lambda u: u[1])
    if slowest not in picked:
        picked.append(slowest)
    rows = [u[0] % tr["n_inputs"] for u in picked]
    cases = [(pool, rows, strategy,
              torch.cat([u[2]["idx"] for u in picked]),
              torch.cat([u[2]["log_prob"] for u in picked]),
              torch.cat([u[2]["rmse"] for u in picked]))]
    readings = al.judge(cf, cases, T, n_ctx, dev, len(rows))
    del readings["uncertainty_gap"]
    times = [u[1] for u in done]
    return dict(end_to_end={"experiment_ms_p95":
                            1e3 * quantile(times, 0.95)},
                readings=readings, attempted=len(done), failed=0,
                memory_peak_bytes=peak, device_kind=kind)
