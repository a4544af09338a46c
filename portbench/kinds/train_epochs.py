"""Training: each unit is one main-phase epoch of the program's
``Trainer.train_epoch`` (rollout with remat, the REINFORCE + NLL loss,
backward, clipped AdamW), ending when its metrics reach the host.  End
to end: ``train_rollouts_per_s``, batch rows of the epochs completed in
the window over the time from its start to the end of the last.

Set-up builds one trainer (the configuration's weights, the main
phase's optimizer) and drives it through ``checked_steps`` epochs of the
window's own call and feed, which the reference then follows: each
step's loss, the first gradient as the optimizer holds it, the
parameters' change after the last, and the Gumbel-max gap of each
design the program drew.  The batches come from the benchmark's GP
draws (``gen.gp_batch``, a new batch each epoch, seeded by the epoch);
the design noise, T and the mask from the trainer's own streams, which
the check draws again from their recorded states.
"""
from __future__ import annotations

import logging
import random
import shutil
import statistics
import sys
import tempfile
import time

import torch

from portbench import al, gen, program
from portbench.counts import aline_flops
from portbench.harness import load_peaks
from portbench.reference.model import Inputs, load_params, precision
from portbench.reference.train import train_steps
from portbench.trace import traced


class Feed:
    """The trainer's task: a new GP batch an epoch from the benchmark's
    draws (the trainer's generator, passed in, is left alone)."""

    def __init__(self, task: dict, seed: int, device):
        self.task, self.seed, self.device = task, seed, device
        self.n_context_init = task["n_context_init"]
        self.n_target_data = task["n_target_data"]
        self.n_target_theta = task["n_target_theta"]
        self.k = 0

    def draw(self, k, batch_size, n_query):
        return gen.gp_batch(gen.generator(self.device, self.seed, 0, k),
                            batch_size, n_query, self.task)

    def sample_batch(self, gen_unused, batch_size, n_query=None):
        d = self.draw(self.k, batch_size, n_query)
        self.k += 1
        return al.program_batch(d, self.n_context_init)


def epoch_mask(pystate, run: dict, T: int):
    """The epoch's T and target mask, drawn again from the state of the
    trainer's host stream before the epoch: T, then the mask type, then
    for ``split`` a fair coin between the data and the theta targets."""
    task = run["task"]
    rng = random.Random()
    rng.setstate(pystate)
    T = rng.randint(T, T)            # the trainer runs min_T = T
    kind = rng.choice(list(task["mask_type"]))
    if kind != "split" or task["embedding_type"] != "mix":
        raise NotImplementedError(f"mask_type {kind!r} is not drawn here")
    nd, nt = task["n_target_data"], task["n_target_theta"]
    data = task["attend_to"] == "data" if task["attend_to"] else \
        rng.choice([True, False])
    mask = torch.zeros(nd + nt, dtype=torch.bool)
    mask[:nd] = data
    mask[nd:] = not data
    return T, mask


def weights(mask: torch.Tensor, nd: int):
    """(w_query, w_pred): the masked targets' mean, and the data targets'
    mean plus the theta targets' mean."""
    w_q = mask.float() / mask.float().sum()
    w_p = torch.zeros(mask.shape[0])
    w_p[:nd] = 1.0 / nd
    w_p[nd:] = 1.0 / (mask.shape[0] - nd)
    return w_q, w_p


def run(ctx):
    import aline_tpu_torch.train.loop as loop
    from aline_tpu_torch.utils.serialization import _torch_key
    cf, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.run
    r = cf["run"]
    task = r["task"]
    B, T, nq = tr["batch_size"], tr["T"], tr["n_query"]
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    pcfg = program.run_config(cf, seed=ctx.seed, output_dir=out_dir,
                              checkpoint=0, load_checkpoint=False,
                              batch_size=B, T=T, min_T=T,
                              task=dict(task, n_query_init=nq))
    _, model = program.model(cf, dev)
    trainer = loop.Trainer(pcfg, logger=logging.getLogger("portbench"),
                           device=dev, model=model.train())
    feed = Feed(task, ctx.seed, dev)
    trainer.task = feed
    epoch = pcfg.burning_epoch          # the main phase from its start
    names = [n for n, _ in trainer.model.named_parameters()]
    params = dict(trainer.model.named_parameters())

    # the checked steps: the window's own call and feed
    steps, idx_seen = [], []
    orig = loop.rollout

    def rollout(*a, **kw):
        ro = orig(*a, **kw)
        idx_seen.append(ro.idx.detach().clone())
        return ro

    loop.rollout = rollout
    try:
        for s in range(tr["checked_steps"]):
            st = dict(k=feed.k, pystate=trainer.pyrng.getstate(),
                      genstate=trainer.gen.get_state())
            m = trainer.train_epoch(epoch)
            st["loss"] = float(m["loss"])
            st["predict"] = float(m["predict_loss"])
            epoch += 1
            if s == 0:
                opt = trainer.optimizer
                # an optimizer that holds no moment moved nothing
                grad1 = {n: (opt.state[params[n]].get(
                    "exp_avg", torch.zeros_like(params[n]))
                    / (1 - opt.param_groups[0]["betas"][0]))
                    .detach().clone() for n in names}
            steps.append(st)
    finally:
        loop.rollout = orig
    for st, idx in zip(steps, idx_seen):
        st["idx"] = idx
    p_last = {n: params[n].detach().clone() for n in names}

    def unit():
        nonlocal epoch
        state = trainer.pyrng.getstate()
        m = trainer.train_epoch(epoch)
        float(m["loss"])
        epoch += 1
        return state

    for _ in range(tr["warmup_units"]):
        unit()
    ctx.open_window()
    sizes = aline_flops.sizes_of(r)
    flops = 0
    n = 0
    t0 = time.perf_counter()
    while True:
        with rec.span("unit", ctx.sync):
            state = unit()
        Tm, mask = epoch_mask(state, r, T)
        flops += 3 * aline_flops.rollout(
            sizes, B, task["n_context_init"] + nq, task["n_context_init"],
            task["n_target_data"], task["n_target_theta"], int(mask.sum()),
            Tm, final=False)
        n += 1
        t_end = time.perf_counter()
        if t_end - t0 >= ctx.seconds:
            break
    rec.units, rec.window_s = n, t_end - t0
    rec.counts.update(model_flops=flops, peak_flops=load_peaks()[
        "bf16_flops"])
    if ctx.trace:
        rec.trace = {}
        with traced(rec.trace):
            for _ in range(tr["trace_units"]):
                unit()
        rec.trace_units = tr["trace_units"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    del trainer, model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)

    flax = {k[len("params/"):]: _torch_key(k)[0] for k in program.weights(cf)}
    readings = check(ctx, steps, grad1, p_last, flax)
    return dict(end_to_end={"train_rollouts_per_s": n * B / rec.window_s},
                readings=readings, attempted=n, failed=0,
                memory_peak_bytes=peak, device_kind=kind)


def _leaf_gaps(prog: dict, ref: dict, keys, label: str) -> dict:
    """Each leaf's gap between the program's and the reference's norms,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger (the worst three go to standard error)."""
    pn = {k: float(prog[k].norm()) for k in keys}
    rn = {k: float(ref[k].norm()) for k in keys}
    med = statistics.median(rn.values())
    gap = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}
    worst = sorted(keys, key=lambda k: -gap[k])[:3]
    print(f"portbench: {label} worst leaves " + ", ".join(
        f"{k} {gap[k]:.4g} ({pn[k]:.4g} vs {rn[k]:.4g})" for k in worst)
        + f"; median leaf {statistics.median(gap.values()):.4g}",
        file=sys.stderr)
    return gap


def reference_steps(cf, tr, dev, seed, steps) -> list:
    """The reference's inputs of each checked step, drawn again: the
    batch from the benchmark's stream, T and the mask from the recorded
    host stream, the design noise from the recorded generator state."""
    r = cf["run"]
    task = r["task"]
    B, nq = tr["batch_size"], tr["n_query"]
    feed = Feed(task, seed, dev)
    out = []
    for st in steps:
        T, mask = epoch_mask(st["pystate"], r, tr["T"])
        d = feed.draw(st["k"], B, nq)
        g = torch.Generator(device=dev)
        g.set_state(st["genstate"])
        noise = gen.gumbel(g, (T, B, d["x"].shape[1]))
        w_q, w_p = weights(mask, task["n_target_data"])
        ctx0 = torch.zeros(d["x"].shape[:2], dtype=torch.bool, device=dev)
        ctx0[:, :task["n_context_init"]] = True
        out.append(dict(
            inp=Inputs(d["x"], d["y"], d["target_x"],
                       task["n_target_theta"], mask.to(dev)),
            ctx0=ctx0, targets=al.targets_of(d)[..., 0], w_q=w_q.to(dev),
            w_p=w_p.to(dev), noise=noise, idx=st.get("idx")))
    return out


def hyper(cf) -> dict:
    r = cf["run"]
    return dict(gamma=r["gamma"], alpha=r["alpha"], lr=r["lr"],
                decay_steps=r["max_epoch"] - r["burning_epoch"])


def judge(cf, tr, dev, ref_steps, losses, predicts, g_prog, d_prog,
          prec=None):
    """Readings of a trainer's ``losses`` and their all-targets NLL parts
    ``predicts`` (per step), first clipped
    gradient ``g_prog`` and change after the last step ``d_prog`` (both
    keyed by the flax names, in the flax layout) against the reference
    following the same designs (``ref_steps``' ``idx``)."""
    P0 = load_params(program.weights_path(cf), dev)
    res = train_steps(P0, ref_steps, program.arch(cf), hyper(cf),
                      prec or precision(cf["precision"]),
                      block=tr["reference_block_rows"])
    d_ref = {k: res["P"][k] - P0[k] for k in res["P"]}
    # elements whose reference gradient is nought to rounding (a key's
    # bias under softmax) move under Adam by round-off alone: left out
    g1 = res["grad1"]
    rms = statistics.median(float(v.norm()) / v.numel() ** 0.5
                            for v in g1.values())
    keep = {k: g1[k].abs() >= 1e-3 * rms for k in g1}
    moved = [k for k in keep if bool(keep[k].any())]
    for s, (a, b, g) in enumerate(zip(losses, res["loss"],
                                      res["design_gap"])):
        print(f"portbench: step {s} loss {a!r} reference {b!r} "
              f"widest design gap {g!r} first designs' mean gap "
              f"{res['first_design_gap'][s]!r}", file=sys.stderr)
    _leaf_gaps(g_prog, g1, list(g1), "first gradient (not compared)")
    change = _leaf_gaps({k: d_prog[k][keep[k]] for k in moved},
                        {k: d_ref[k][keep[k]] for k in moved}, moved,
                        "change")
    # Compared: every step's loss, the first step's NLL part and its
    # first designs' mean gap, and the median leaf's change.  The later steps follow parameters
    # that Adam's first update has already moved apart on rounding; the
    # first gradient (reported above) and the first loss's reward part
    # carry the rounding of the reward's per-step normalisation, and do
    # not separate a sound run from the control or from a batch half
    # left out (PERF.md, the training cell's limits).
    print(f"portbench: first step NLL {predicts[0]!r} reference "
          f"{res['predict'][0]!r}", file=sys.stderr)
    return dict(
        loss_gap=max(abs(a - b) for a, b in zip(losses, res["loss"])),
        first_predict_gap=abs(predicts[0] - res["predict"][0]),
        design_gap=res["first_design_gap"][0],
        change_gap=statistics.median(change.values()))


def check(ctx, steps, grad1, p_last, flax) -> dict:
    cf, tr, dev = ctx.config, ctx.traffic, ctx.device
    P0 = load_params(program.weights_path(cf), dev)

    def flax_layout(k, t):
        return t.t() if k.endswith("/kernel") else t

    g_prog = {k: flax_layout(k, grad1[flax[k]]) for k in P0}
    d_prog = {k: flax_layout(k, p_last[flax[k]]) - P0[k] for k in P0}
    return judge(cf, tr, dev, reference_steps(cf, tr, dev, ctx.seed, steps),
                 [st["loss"] for st in steps],
                 [st["predict"] for st in steps], g_prog, d_prog)
