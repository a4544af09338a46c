"""Batched active-learning evaluation: each unit is one batch of
``batch_size`` GP experiments rolled out under every strategy by
``compare_strategies``, as ``eval_al`` calls it.  End to end:
``eval_rollouts_per_s``, rollouts (rows x strategies) of the batches
completed in the window over the window."""
from __future__ import annotations

import random
import time

import torch

from portbench import al, gen, program
from portbench.counts import aline_flops, gmm_head
from portbench.harness import load_peaks
from portbench.reference.eig import derive_seed
from portbench.trace import traced


def run(ctx):
    from aline_tpu_torch.eval.al_curves import compare_strategies
    cf, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.run
    task = cf["run"]["task"]
    n_ctx = task["n_context_init"]
    B, nq, T = tr["batch_size"], tr["n_query"], tr["T"]
    strategies = tuple(tr["strategies"])
    pcfg, model = program.model(cf, dev)
    inputs = [gen.gp_batch(gen.generator(dev, ctx.seed, 0, k), B, nq, task)
              for k in range(tr["n_inputs"])]

    def call(k):
        d = inputs[k % len(inputs)]
        curves = compare_strategies(
            model, al.program_batch(d, n_ctx), T,
            gen.generator(dev, ctx.seed, 1, k), strategies=strategies,
            time_token=pcfg.time_token)
        return {s: {n: v.cpu() for n, v in o.items()}
                for s, o in curves.items()}

    k = 0
    for _ in range(tr["warmup_units"]):
        call(k)
        k += 1
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
    sizes = aline_flops.sizes_of(cf["run"])
    n_pts = n_ctx + nq
    per_unit = sum(aline_flops.rollout(
        sizes, B, n_pts, n_ctx, task["n_target_data"],
        task["n_target_theta"], task["n_target_data"]
        + task["n_target_theta"], T, final=True,
        pool_posterior=s == "uncertainty") for s in strategies)
    rec.counts.update(
        model_flops=per_unit * len(done), peak_flops=peaks["bf16_flops"],
        gmm_pool_least_s=gmm_head.fwd_least_s(
            B, n_pts, sizes["D"], sizes["F"], sizes["C"], peaks),
        gmm_pool_calls_per_unit=(len(strategies) * (T + 1)
                                 if n_pts >= cf["precision"][
                                     "gmm_head_pool_min_tokens"] else 0))
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
    cases = []
    for unit, res in rng.sample(done, min(tr["check_units"], len(done))):
        rows = sorted(rng.sample(range(B), min(tr["check_rows"], B)))
        for s in strategies:
            o = res[s]
            cases.append((inputs[unit % len(inputs)], rows, s,
                          o["idx"][rows], o["log_prob"][rows],
                          o["rmse"][rows]))
    readings = al.judge(cf, cases, T, n_ctx, dev,
                        tr["reference_block_rows"])
    return dict(end_to_end={"eval_rollouts_per_s":
                            len(done) * B * len(strategies) / window},
                readings=readings, attempted=len(done), failed=0,
                memory_peak_bytes=peak, device_kind=kind)
