"""Live psychometric experiments with human subjects, one at a time: each
unit is one subject's experiment run through the program's
``LiveExperiment``, T trials, each a stimulus proposed and read on the
host, the subject's answer computed on the host from it
(``reference/psych.py`` ``respond``, with the trial's uniform from the
seed) and written back, then the posterior.  Experiment k targets the
traffic's mask k mod 3.  The program is given the candidate stimuli and
the initial context's answers, never the subject's parameters.  The clock
runs from the session's creation to its posterior on the host.  End to
end: ``experiment_ms_p95``, the 95th percentile of the experiments'
times in the window.

Under ``--trace 1`` the ``trace_units`` experiments profiled after the
window run with the program's tracing on, and their trace leaves out the
tracing's own annotations (``aline/<span>``).  ``run.spans["trial"]``
holds the host seconds of their ``live.trial`` spans, and
``run.counts["live_trials"]`` the sum of their ``live.trials`` counter;
a program without them leaves both out, and their readers read None.

The check, on ``check_units`` experiments drawn from the seed and the
slowest: the program's context is the stimuli it showed with the answers
the subject gave (``response_mismatch``: experiments where it is not),
no stimulus shown twice (``invalid_choices``), each stimulus the
reference's argmax (``design_gap``), and the final posterior's curves at
the subject's parameters the reference's (``log_prob_gap``,
``rmse_gap``).  The module carries its tiny sizes (``TINY``), its control
and its fault (``FAULTS``).
"""
from __future__ import annotations

import random
import sys
import time

import torch

from portbench import gen, gen_psych, program
from portbench.harness import quantile
from portbench.reference.eig import derive_seed
from portbench.reference.model import load_params, posterior_curves, \
    precision
from portbench.reference.psych import N_THETA, control as psych_control, \
    replay, respond
from portbench.trace import summarise

TINY = dict(n_query=20, T=4, n_inputs=12, check_units=5, warmup_units=3,
            trace_units=3, reference_block_rows=4)
FAULTS = ("response_flipped",)


def _masks(tr: dict, dev):
    return [torch.tensor(m, device=dev) for _, m in tr["masks"]]


def _weights(mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return m / m.sum()


def _answers0(d: dict) -> torch.Tensor:
    """The initial context's answers [n, n_ctx], on the host."""
    x, th, u0 = d["x"][..., 0].tolist(), d["theta"].tolist(), d["u0"].tolist()
    return torch.tensor([[respond(a, s, v) for a, v in zip(xr, ur)]
                         for xr, s, ur in zip(x, th, u0)])


class _Unannotated:
    """A profile without the program's span annotations."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        return [e for e in self.prof.events()
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("aline/"))]


def run(ctx):
    from aline_tpu_torch.eval.live import LiveExperiment
    cf, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.run
    task = cf["run"]["task"]
    n_ctx, nq, T, n = task["n_context_init"], tr["n_query"], tr["T"], \
        tr["n_inputs"]
    if tr["batch_size"] != 1:
        raise ValueError("a live experiment is one subject")
    pcfg, model = program.model(cf, dev)
    d = gen_psych.subjects(gen.generator(dev, ctx.seed, 0), n, nq, T, task)
    host = {k: v.cpu() for k, v in d.items()}
    theta, us = host["theta"].tolist(), host["u"].tolist()
    y0 = _answers0(host)
    Y = torch.zeros(d["x"].shape[:2] + (1,), device=dev)
    Y[:, :n_ctx, 0] = y0.to(dev)
    empty = torch.zeros(1, 0, task["dim_x"], device=dev)
    unknown = torch.zeros(1, N_THETA, 1, device=dev)   # never given
    masks = _masks(tr, dev)

    def call(k):
        s, m = k % n, k % len(masks)
        b = program.batch(d["x"][s:s + 1], Y[s:s + 1], empty, unknown,
                          unknown, n_ctx, masks[m])
        ctx.sync()
        t0 = time.perf_counter()
        sess = LiveExperiment(model, b, T, time_token=pcfg.time_token)
        shown, given = [], []
        for t in range(T):
            idx, x = sess.propose()
            a = respond(float(x[0, 0]), theta[s], us[s][t])
            sess.observe(a)
            shown.append(int(idx[0]))
            given.append(a)
        post = sess.posterior()
        g = post.gmm
        gmm = torch.stack([g.mixture_means, g.mixture_stds,
                           g.mixture_weights]).cpu()
        dt = time.perf_counter() - t0
        return dt, dict(gmm=gmm, shown=shown, given=given,
                        ctx_idx=post.idx.cpu(), ctx_x=post.x.cpu(),
                        ctx_y=post.y.cpu())

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
    if ctx.trace:
        k = _traced(ctx, call, k)
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
    readings = check(cf, tr, dev, d, host, y0, picked)
    times = [u[1] for u in done]
    return dict(end_to_end={"experiment_ms_p95":
                            1e3 * quantile(times, 0.95)},
                readings=readings, attempted=len(done), failed=0,
                memory_peak_bytes=peak, device_kind=kind)


def _traced(ctx, call, k: int) -> int:
    """Profile ``trace_units`` experiments with the program's tracing on;
    record the trace's summary, the ``live.trial`` spans' host seconds and
    the ``live.trials`` counter."""
    from aline_tpu_torch.utils import metrics
    from torch.profiler import ProfilerActivity, profile
    rec = ctx.run
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ctx.sync()
    metrics.collect()                   # drop what came before
    metrics.set_tracing(True)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ctx.traffic["trace_units"]):
                call(k)
                k += 1
            ctx.sync()
            window = time.perf_counter() - t0
    finally:
        metrics.set_tracing(False)
    rec.trace = summarise(_Unannotated(prof), window)
    rec.trace_units = ctx.traffic["trace_units"]
    spans = metrics.collect()
    trials = [(s.end_ns - s.start_ns) / 1e9 for s in spans
              if s.name == "live.trial"]
    counted = sum(s.counts.get("live.trials", 0) for s in spans)
    if trials:
        rec.spans["trial"] = trials
    if counted:
        rec.counts["live_trials"] = counted
    print(f"live_subjects: traced {len(trials)} trial spans, live.trials "
          f"{counted}, captures "
          f"{sum(s.counts.get('live.graph_captures', 0) for s in spans)}, "
          f"replays "
          f"{sum(s.counts.get('live.graph_replays', 0) for s in spans)}",
          file=sys.stderr)
    return k


def check(cf, tr, dev, d, host, y0, picked) -> dict:
    """Judge the experiments ``picked`` [(k, seconds, record)]."""
    task = cf["run"]["task"]
    n_ctx, T, n = task["n_context_init"], tr["T"], tr["n_inputs"]
    masks = _masks(tr, dev)
    out = dict(design_gap=0.0, response_mismatch=0, invalid_choices=0,
               log_prob_gap=0.0, rmse_gap=0.0)
    X, theta, us = host["x"], host["theta"].tolist(), host["u"].tolist()
    for k, _, o in picked:
        s = k % n
        idx = o["shown"]
        out["invalid_choices"] += (len(set(idx)) < len(idx)
                                   or min(idx) < n_ctx)
        want = [respond(X[s, i, 0], theta[s], us[s][t])
                for t, i in enumerate(idx)]
        ctx_idx = list(range(n_ctx)) + idx
        out["response_mismatch"] += int(
            o["given"] != want
            or o["ctx_idx"][0].tolist() != ctx_idx
            or not torch.equal(o["ctx_x"][0], X[s, ctx_idx])
            or o["ctx_y"][0, :, 0].tolist() != y0[s].tolist() + want)
    P = load_params(program.weights_path(cf), dev)
    prec, arch = precision(cf["precision"]), program.arch(cf)
    blk = tr["reference_block_rows"]
    for m, mask in enumerate(masks):
        group = [(k % n, o) for k, _, o in picked if k % len(masks) == m]
        w = _weights(mask)
        for a in range(0, len(group), blk):
            part = group[a:a + blk]
            rows = torch.tensor([s for s, _ in part], device=dev)
            idx = torch.tensor([o["shown"] for _, o in part], device=dev)
            ans = torch.tensor([o["given"] for _, o in part], device=dev)
            res = replay(P, d["x"][rows], y0[rows.cpu()].to(dev), idx, ans,
                         d["theta"][rows], mask, w, prec, arch)
            out["design_gap"] = max(out["design_gap"],
                                    float(res["gap"].max()))
            gmm = torch.stack([o["gmm"][:, 0] for _, o in part], 1).to(dev)
            lp, rm = posterior_curves(tuple(gmm), d["theta"][rows], w)
            out["log_prob_gap"] = max(out["log_prob_gap"], float(
                (lp - res["log_prob"][:, -1]).abs().max()))
            out["rmse_gap"] = max(out["rmse_gap"], float(
                (rm - res["rmse"][:, -1]).abs().max()))
    return out


def control(cf, tr, dev, seed) -> dict:
    """The reference one precision below the configuration's in the
    program's place, on the subjects and masks of a run of that seed's
    check sample: the gap, under the reference, of each stimulus the
    lower precision puts first, and its final posterior's curves against
    the reference's."""
    task = cf["run"]["task"]
    n = tr["n_inputs"]
    d = gen_psych.subjects(gen.generator(dev, seed, 0), n, tr["n_query"],
                           tr["T"], task)
    y0 = _answers0({k: v.cpu() for k, v in d.items()}).to(dev)
    P = load_params(program.weights_path(cf), dev)
    ref, ctl = precision(cf["precision"]), precision(cf["precision"], True)
    arch = program.arch(cf)
    masks = _masks(tr, dev)
    rng = random.Random(derive_seed(seed, 3))
    ks = rng.sample(range(n), min(tr["check_units"] + 1, n))
    out = dict(design_gap=0.0, response_mismatch=0, invalid_choices=0,
               log_prob_gap=0.0, rmse_gap=0.0)
    blk = tr["reference_block_rows"]
    for m, mask in enumerate(masks):
        rows = [k for k in ks if k % len(masks) == m]
        for a in range(0, len(rows), blk):
            r = torch.tensor(rows[a:a + blk], device=dev)
            gap, lp, rm = psych_control(P, d["x"][r], y0[r], d["theta"][r],
                                        d["u"][r], mask, _weights(mask), ref,
                                        ctl, arch)
            out["design_gap"] = max(out["design_gap"], gap)
            out["log_prob_gap"] = max(out["log_prob_gap"], float(lp.max()))
            out["rmse_gap"] = max(out["rmse_gap"], float(rm.max()))
    return out


def plant(fault: str, setattr_):
    """``response_flipped``: the program writes the opposite of the second
    answer of every experiment into its context."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    from aline_tpu_torch.eval import live
    orig = live.LiveExperiment.observe

    def observe(self, response):
        n = getattr(self, "_planted_n", 0)
        self._planted_n = n + 1
        return orig(self, 1.0 - float(response) if n == 1 else response)

    setattr_(live.LiveExperiment, "observe", observe)
