"""Training through the flash-attention kernels: the unit, window, checks
and end-to-end metric of ``train_epochs`` (its own module, run as it
is), with the configuration's ``attention_impl=flash``; in a traced run
the profiled unit also counts the program's flash launches.

Under ``--trace 1`` the program's tracing is on for the profiled unit
after the window alone, and that unit's trace leaves out the tracing's
own annotations (``aline/<span>``, which the profiler lists as device
intervals), so that its idle share and operation count read the same
work as an untraced unit.  It records in ``run.counts``:

* ``flash_plan_launches``, ``flash_fwd_launches``,
  ``flash_bwd_launches``: the program's counters ``flash.plan``,
  ``flash.fwd``, ``flash.bwd`` summed over the unit's spans (left out
  where the program has no such counter);
* ``flash_fwd_least_s``, ``flash_bwd_least_s`` and the calls they cover
  (``flash_fwd_least_calls``, ``flash_bwd_least_calls``):
  ``counts/flash_attn.py`` at the shapes, T and target mask of each
  rollout the unit ran, read from the program's own call.

The module carries its tiny sizes (``TINY``), its control and its
faults, those of the training cell (``control.py``).
"""
from __future__ import annotations

import contextlib
import sys
import time

from portbench import control as _control
from portbench.counts import aline_flops, flash_attn
from portbench.harness import load_kind, load_peaks
from portbench.reference.flash import attention
from portbench.trace import summarise

TINY = dict(batch_size=8, T=4, n_query=12, checked_steps=3, warmup_units=1,
            reference_block_rows=4)
FAULTS = ("state_unchanged", "half_batch", "design_altered")
COUNTERS = {"flash.plan": "flash_plan_launches",
            "flash.fwd": "flash_fwd_launches",
            "flash.bwd": "flash_bwd_launches"}


def control(cf, tr, dev, seed) -> dict:
    """The training cell's control (the reference one precision lower,
    trained on its own designs) with the configuration's attention."""
    with attention(cf["precision"]):
        return _control.control_train(cf, tr, dev, seed)


def plant(fault: str, setattr_):
    """One of ``FAULTS``, planted in the training path that both training
    cells run."""
    _control.plant("al1d_200k.train_b200", fault, setattr_)


class _Unannotated:
    """A profile without the program's span annotations."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        return [e for e in self.prof.events()
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("aline/"))]


def _launches(spans) -> tuple:
    """The counters summed over ``spans``, and the forwards counted under
    a ``train.backward`` span (the recomputed ones)."""
    by_id = {s.id: s for s in spans}

    def in_backward(s):
        while s is not None:
            if s.name == "train.backward":
                return True
            s = by_id.get(s.parent)
        return False

    total = dict.fromkeys(COUNTERS, 0)
    fwd_bwd = 0
    for s in spans:
        for name in COUNTERS:
            total[name] += s.counts.get(name, 0)
        if s.counts.get("flash.fwd") and in_backward(s):
            fwd_bwd += s.counts["flash.fwd"]
    return total, fwd_bwd


def _least(cf: dict, calls) -> dict:
    """``counts/flash_attn.py``'s calls and least seconds of the
    rollouts ``calls`` [(B, n_points, T, n_sel)]."""
    r = cf["run"]
    task = r["task"]
    sizes, peaks = aline_flops.sizes_of(r), load_peaks()
    out = dict(flash_fwd_least_calls=0, flash_bwd_least_calls=0,
               flash_fwd_least_s=0.0, flash_bwd_least_s=0.0)
    for B, n_points, T, n_sel in calls:
        n, s = flash_attn.rollout_least_s(
            sizes, r["encoder"]["n_head"], B, n_points,
            task["n_context_init"],
            task["n_target_data"] + task["n_target_theta"], n_sel, T,
            r["rollout_remat"], peaks)
        for part in ("fwd", "bwd"):
            out[f"flash_{part}_least_calls"] += n[part]
            out[f"flash_{part}_least_s"] += s[part]
    return out


def _traced_counted(ctx):
    """``trace.traced`` for ``train_epochs``' profiled unit, with the
    program's tracing on and its counters read into ``ctx.run.counts``."""

    @contextlib.contextmanager
    def traced(out):
        import aline_tpu_torch.train.loop as loop
        from aline_tpu_torch.utils import metrics
        from torch.profiler import ProfilerActivity, profile
        rollouts = []
        orig = loop.rollout

        def rollout(model, batch, T, *a, **kw):
            rollouts.append((batch.x.shape[0], batch.x.shape[1], T,
                             batch.target_mask))
            return orig(model, batch, T, *a, **kw)

        acts = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        ctx.sync()
        metrics.collect()               # drop what the set-up left
        loop.rollout = rollout
        metrics.set_tracing(True)
        try:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                yield
                ctx.sync()
                window = time.perf_counter() - t0
        finally:
            metrics.set_tracing(False)
            loop.rollout = orig
        out.update(summarise(_Unannotated(prof), window))
        total, fwd_bwd = _launches(metrics.collect())
        counts = ctx.run.counts
        counts.update({COUNTERS[k]: v for k, v in total.items() if v})
        counts.update(_least(ctx.config, [
            (B, n, T, int(m.sum())) for B, n, T, m in rollouts]))
        print(f"train_flash: traced launches {total}, forwards under "
              f"train.backward {fwd_bwd}", file=sys.stderr)

    return traced


def run(ctx):
    base = load_kind("train_epochs")    # a module of its own: patched here
    base.traced = _traced_counted(ctx)
    check = base.check

    def checked(*a, **kw):
        with attention(ctx.config["precision"]):
            return check(*a, **kw)

    base.check = checked
    return base.run(ctx)
