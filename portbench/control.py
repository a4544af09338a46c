"""The readings that set each cell's limits, at the cell's own sizes.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
        [--program --seconds 3]

Without ``--program``: the control, the plain reference computed one
precision below the configuration's (``reference.model.precision``:
float8 for bfloat16, bfloat16 for float32), put in the program's place
and judged as a run judges the program, on the same inputs as a run of
that seed.  With ``--program``: the program's own readings, one short
run a seed, all in this process.  One JSON line a seed.  The
benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import random

import torch

from portbench import al, gen, program
from portbench.harness import find_cell, load_benchmark, load_config, \
    load_kind, load_traffic
from portbench.reference.eig import derive_seed, loc_bounds
from portbench.reference.model import Inputs, Rounder, load_params, precision
from portbench.reference.rollouts import control_rollout


def _al_cases(cf, tr, dev, seed):
    """The run's check sample, drawn from the seed alike: (batch, rows)."""
    task = cf["run"]["task"]
    rng = random.Random(derive_seed(seed, 3))
    if tr["kind"] == "live_experiments":
        pool = gen.gp_batch(gen.generator(dev, seed, 0), tr["n_inputs"],
                            tr["n_query"], task)
        return [(pool, sorted(rng.sample(range(tr["n_inputs"]),
                                         tr["check_units"] + 1)))]
    B = tr["batch_size"]
    return [(gen.gp_batch(gen.generator(dev, seed, 0, k), B, tr["n_query"],
                          task), sorted(rng.sample(range(B),
                                                   tr["check_rows"])))
            for k in range(tr["check_units"])]


def control_al(cf, tr, dev, seed):
    P = load_params(program.weights_path(cf), dev)
    ref, ctl = precision(cf["precision"]), precision(cf["precision"], True)
    arch = program.arch(cf)
    n_ctx = cf["run"]["task"]["n_context_init"]
    n_theta = cf["run"]["task"]["n_target_theta"]
    strategies = tr.get("strategies", [tr.get("strategy")])
    out = dict(design_gap=0.0, uncertainty_gap=0.0, log_prob_gap=0.0,
               rmse_gap=0.0, invalid_choices=0)
    g = gen.generator(dev, seed, 4)
    for d, rows in _al_cases(cf, tr, dev, seed):
        blk = tr.get("reference_block_rows", len(rows))
        for a in range(0, len(rows), blk):
            r = torch.as_tensor(rows[a:a + blk], device=dev)
            inp = al.reference_inputs(d, r, n_theta)
            ctx0 = torch.zeros(inp.x.shape[:2], dtype=torch.bool,
                               device=dev)
            ctx0[:, :n_ctx] = True
            targets = al.targets_of(d)[r][..., 0]
            w = torch.full((targets.shape[1],), 1.0 / targets.shape[1],
                           device=dev)
            for s in strategies:
                res = control_rollout(P, inp, ctx0, targets, w, tr["T"], s,
                                      ref, ctl, arch, g)
                key = {"aline": "design_gap",
                       "uncertainty": "uncertainty_gap"}.get(s)
                if key and res["gap"].numel():
                    out[key] = max(out[key], float(res["gap"].max()))
                out["log_prob_gap"] = max(out["log_prob_gap"],
                                          float(res["log_prob_gap"].max()))
                out["rmse_gap"] = max(out["rmse_gap"],
                                      float(res["rmse_gap"].max()))
    if tr["kind"] == "live_experiments":
        del out["uncertainty_gap"]
    return out


def control_bed(cf, tr, dev, seed):
    task = cf["run"]["task"]
    P = load_params(program.weights_path(cf), dev)
    ref, ctl = precision(cf["precision"]), precision(cf["precision"], True)
    arch = program.arch(cf)
    n_ctx, T, B = task["n_context_init"], tr["T"], tr["batch_size"]
    rng = random.Random(derive_seed(seed, 3))
    d = gen.loc_batch(gen.generator(dev, seed, 0, 0), B, tr["n_query"],
                      task)
    rows = torch.tensor(sorted(rng.sample(range(B), tr["check_rows"])),
                        device=dev)
    n_theta = task["K"] * task["dim_x"]
    out = dict(design_gap=0.0, history_mismatch=0, pce_gap=0.0,
               nmc_gap=0.0)
    idx = []
    for a in range(0, len(rows), tr["reference_block_rows"]):
        r = rows[a:a + tr["reference_block_rows"]]
        x = d["x"][r]
        inp = Inputs(x, d["y"][r], x.new_zeros(len(r), 0, x.shape[-1]),
                     n_theta, torch.ones(n_theta, dtype=torch.bool,
                                         device=dev))
        ctx0 = torch.zeros(x.shape[:2], dtype=torch.bool, device=dev)
        ctx0[:, :n_ctx] = True
        res = control_rollout(P, inp, ctx0, None, None, T, "aline", ref, ctl,
                              arch, None, curves=False)
        out["design_gap"] = max(out["design_gap"], float(res["gap"].max()))
        idx.append(res["idx"])
    idx = torch.cat(idx)
    x, y = d["x"][rows], d["y"][rows]
    xs = torch.cat([x[:, :n_ctx], torch.gather(
        x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))], dim=1)
    ys = torch.cat([y[:, :n_ctx], torch.gather(y, 1, idx[..., None])], 1)
    s = derive_seed(seed, 2, 0)
    bounds = [loc_bounds(d["theta"][rows], xs, ys, tr["L"], s,
                         tr["L_chunk"], task, Rounder(p), B_draw=B,
                         rows=rows)
              for p in (cf["precision"]["bounds"],
                        {"float32": "bfloat16"}[cf["precision"]["bounds"]])]
    out["pce_gap"] = float((bounds[0][0] - bounds[1][0]).abs().max())
    out["nmc_gap"] = float((bounds[0][1] - bounds[1][1]).abs().max())
    return out


def control_train(cf, tr, dev, seed):
    """The reference trained at the lower precision on its own Gumbel-max
    designs, from the streams a trainer of this seed starts with, then
    judged as the program is."""
    from portbench.reference.train import train_steps
    kind = load_kind("train_epochs")
    task = cf["run"]["task"]
    pyrng = random.Random(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    steps = []
    for s in range(tr["checked_steps"]):
        steps.append(dict(k=s, pystate=pyrng.getstate(),
                          genstate=g.get_state()))
        # the trainer's draws of an epoch: T, the mask, the design noise
        pyrng.randint(tr["T"], tr["T"])
        pyrng.choice(list(task["mask_type"]))
        pyrng.choice([True, False])
        gen.gumbel(g, (tr["T"], tr["batch_size"],
                       task["n_context_init"] + tr["n_query"]))
    ref_steps = kind.reference_steps(cf, tr, dev, seed, steps)
    P0 = load_params(program.weights_path(cf), dev)
    ctl = train_steps(P0, ref_steps, program.arch(cf), kind.hyper(cf),
                      precision(cf["precision"], True),
                      block=tr["reference_block_rows"])
    for st, i in zip(ref_steps, ctl["idx"]):
        st["idx"] = i
    return kind.judge(cf, tr, dev, ref_steps, ctl["loss"], ctl["predict"],
                      ctl["grad1"], {k: ctl["P"][k] - P0[k] for k in P0})


# -- faults planted under the timed path ------------------------------------
def _altered(out, half: bool):
    """Designs altered where they are produced: every row's first design
    moved to another point, or (``half``) the second half of the rows
    given the first half's rollouts."""
    for o in (out.values() if "aline" in out else [out]):
        if half:
            n = o["idx"].shape[0] // 2
            for v in o.values():
                v[n:2 * n] = v[:n].clone()
        else:
            o["idx"][:, 0] = (o["idx"][:, 0] + 1) % 4 + 1
    return out


def _bumped(bounds, half: bool):
    """Bounds altered where they are produced: sPCE moved by 0.5, or
    (``half``) the second half of the rows given the first half's."""
    pce, nmc = bounds
    if not half:
        return pce + 0.5, nmc
    n = pce.shape[0] // 2
    return tuple(torch.cat([t[:n], t[:n]])[:t.shape[0]] for t in bounds)


def _half_loss(orig):
    """The loss over the first half of the batch's rows."""
    def loss(ro, *a, **kw):
        n = ro.log_probs.shape[1] // 2
        return orig(type(ro)(*(t[:, :n] if t.dim() >= 2
                               and t.shape[1] == 2 * n else t
                               for t in ro)), *a, **kw)
    return loss


def _shifted(orig):
    """Design noise that forces the design onto candidate 1 wherever it
    is in the pool: the design altered where it is drawn."""
    def noise(shape, g):
        n = orig(shape, g)
        n[:, :, 1] += 1e4
        return n
    return noise


def _wrap(fn, post):
    return lambda *a, **kw: post(fn(*a, **kw))


def plant(cell: str, fault: str, setattr_):
    """Break the timed path of ``cell`` underneath with ``fault`` (one of
    ``FAULTS[cell]``), through ``setattr_(owner, name, value)``."""
    import aline_tpu_torch.eval.al_curves as al_curves
    import aline_tpu_torch.eval.eig as eig
    import aline_tpu_torch.train.loop as loop
    half = fault == "half_batch"
    if cell == "al1d_200k.train_b200":
        if fault == "state_unchanged":
            setattr_(torch.optim.AdamW, "step",
                     lambda self, closure=None: None)
        elif half:
            setattr_(loop, "total_loss", _half_loss(loop.total_loss))
        else:
            setattr_(loop, "gumbel_noise", _shifted(loop.gumbel_noise))
    elif cell == "al1d_200k.eval_pool2000":
        setattr_(al_curves, "compare_strategies",
                 _wrap(al_curves.compare_strategies,
                       lambda o: _altered(o, half)))
    elif cell == "al1d_200k.live_b1":
        setattr_(al_curves, "al_rollout_curves",
                 _wrap(al_curves.al_rollout_curves,
                       lambda o: _altered(o, False)))
    else:
        setattr_(eig, "compute_eig_from_history",
                 _wrap(eig.compute_eig_from_history,
                       lambda b: _bumped(b, half)))


FAULTS = {"al1d_200k.train_b200": ("state_unchanged", "half_batch",
                                   "design_altered"),
          "al1d_200k.eval_pool2000": ("design_altered", "half_batch"),
          "al1d_200k.live_b1": ("design_altered",),
          "loc_100k.bed_L1e6": ("bound_altered", "half_batch")}


CONTROLS = {"al_eval": control_al, "live_experiments": control_al,
            "bed_batches": control_bed, "train_epochs": control_train}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="with --program: a fault of FAULTS planted")
    args = ap.parse_args(argv)
    if args.fault:
        plant(args.workload, args.fault, setattr)
    cell = find_cell(load_benchmark(), args.workload)
    cf, tr = load_config(cell["config"]), load_traffic(cell["traffic"])
    dev = program.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            from portbench.run import execute
            res, _ = execute(args.workload, seed, args.seconds, False,
                             args.device)
            readings = {k: v["value"] for k, v in res["checks"].items()}
        else:
            readings = CONTROLS[tr["kind"]](cf, tr, dev, seed)
        side = "program" if args.program else "control"
        if args.fault:
            side = f"fault {args.fault}"
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side,
                          "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
