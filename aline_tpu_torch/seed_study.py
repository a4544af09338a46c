"""Hold a GP-AL-1D training run of the port to the JAX package's seed
study of the 5k-epoch demo recipe (checkpoints/al1d_5k_demo).

    python -m aline_tpu_torch.seed_study RUN_DIR [--demo-eval NPZ]
        [--artifacts benchmarks/artifacts] [--out JSON]

The run is ``python -m aline_tpu_torch.train`` with ``DEMO_RECIPE +
DEMO_RUN`` (on one H100 about an hour; a run cut short resumes from its
last checkpoint when started again with the same arguments).

The study (``benchmarks/artifacts``, read with numpy):

* ``al1d_seed_variance.npz``: the training ``likelihood`` averaged over
  epochs 4000-4750 for training seeds 7, 8 and 9 (0.566 ± 0.050, the
  sample standard deviation, as docs/PERFORMANCE.md reports it);
* ``al1d_r3_final_eval_seed_variance.npz``: ``eval_al --mask data`` at
  B=200, T=30, n_query=500 of three 5k-epoch runs (seeds 8, 9, 10): the
  final aline LL and RMSE (0.950 ± 0.044, 0.1405 ± 0.0071: the standard
  deviation over the seeds, as ``scripts/seed_variance_report.py``
  prints it), and each run's 200 rows.

Criteria: (a) the run's mean ``likelihood`` over epochs 4000-4750
(every logged epoch of the window; the mean of every 250th beside it)
within 3 sigma of the study's; (b) the run's ``RUN_DIR/eval/
al_curves_data_mask.npz``: aline's final LL and RMSE within 3 sigma of
the study's, and better than random and uncertainty on both; (c) with
``--demo-eval`` (the same ``eval_al`` call on the JAX-trained demo run),
aline's final LL within 4 combined standard errors of the study's
seed-8 row, each standard error from its rows; beside it, read, the
port-trained run minus the JAX-trained demo row by row on the same
batches (``paired``).

Also reads the wall time of the burning and main epochs from
``metrics.jsonl`` (each record's ``time`` is taken at a sync point;
a resumed run starts a new clock).  Prints one JSON object (and writes
it to ``--out``); exits 1 when a criterion is missed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# the demo run's config.json as the trainer's overrides (the run's seed,
# sizes, schedule, dtype and file name; every other key at its default)
DEMO_RECIPE = ("task=al_mix", "task.dim_x=1", "task.n_target_theta=2",
               "task.n_query_init=200", "seed=8", "max_epoch=5000",
               "burning_epoch=1000", "batch_size=200", "min_T=30", "T=30",
               "dtype=bfloat16", "file_name=aline.pth")
# where and how often the port's run writes (not part of the recipe)
DEMO_RUN = ("output_dir=outputs/port_al1d_seed8", "verbose=50",
            "checkpoint=500", "load_checkpoint=true")
WINDOW = (4000, 4750)
SIGMAS = 3          # (a), (b): the spread of the study's training seeds
SIGMAS_DEMO = 4     # (c): combined standard errors of two evals
STRATEGIES = ("aline", "random", "uncertainty")


def metric_records(path: str):
    """The ``metrics`` records of a ``metrics.jsonl`` in file order, each
    with the index of its clock segment (a resume starts a new one)."""
    recs, segment, last_time = [], 0, None
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if d.get("_type") == "config":
                segment += last_time is not None
                last_time = None
                continue
            if d.get("_type") != "metrics":
                continue
            recs.append(dict(d, segment=segment))
            last_time = d["time"]
    return recs


def likelihood_by_step(recs):
    """{step: likelihood}, the last record of a step kept (a resumed run
    logs the epochs after its checkpoint again)."""
    return {r["step"]: r["likelihood"] for r in recs if "likelihood" in r}


def window_means(ll, lo=WINDOW[0], hi=WINDOW[1], coarse=250):
    steps = sorted(s for s in ll if lo <= s <= hi)
    every = [s for s in steps if s % coarse == 0]
    return {"steps": steps, "mean": float(np.mean([ll[s] for s in steps]))
            if steps else None,
            f"mean_every_{coarse}": float(np.mean([ll[s] for s in every]))
            if every else None, f"steps_every_{coarse}": every}


def epoch_seconds(recs, burning_epoch: int):
    """Seconds an epoch between consecutive records of one clock segment,
    split into burning and main intervals: {phase: [s, ...]}."""
    out = {"burning": [], "main": []}
    for a, b in zip(recs, recs[1:]):
        if a["segment"] != b["segment"] or b["step"] <= a["step"]:
            continue
        per = (b["time"] - a["time"]) / (b["step"] - a["step"])
        if b["step"] <= burning_epoch:
            out["burning"].append(per)
        elif a["step"] >= burning_epoch:
            out["main"].append(per)
    return out


def finals(path: str):
    """{strategy: {metric: (mean, standard error, rows)}} of the final
    step of an ``eval_al`` npz, every seed's rows pooled."""
    with np.load(path) as d:
        keys = set(d.files)
        out = {}
        for s in STRATEGIES:
            out[s] = {}
            for m in ("log_prob", "rmse"):
                rows = np.concatenate([d[k][:, -1] for k in sorted(keys)
                                       if k == f"{s}_{m}" or (
                                           k.startswith("seed")
                                           and k.endswith(f"_{s}_{m}"))])
                out[s][m] = (float(rows.mean()),
                             float(rows.std(ddof=1) / np.sqrt(len(rows))),
                             int(len(rows)))
    return out


def hold(run_dir: str, demo_eval=None, artifacts="benchmarks/artifacts"):
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    recs = metric_records(os.path.join(run_dir, "metrics.jsonl"))
    ll = likelihood_by_step(recs)
    per = epoch_seconds(recs, cfg["burning_epoch"])
    res = {"run_dir": run_dir, "last_logged_epoch": max(ll) if ll else None,
           "segments": 1 + max((r["segment"] for r in recs), default=0),
           "epoch_ms": {p: {"median": 1e3 * float(np.median(v)),
                            "mean": 1e3 * float(np.mean(v)),
                            "intervals": len(v)} if v else None
                        for p, v in per.items()},
           "criteria": {}}
    train = np.load(os.path.join(artifacts, "al1d_seed_variance.npz"))
    study = np.array([float(train[k]) for k in sorted(train.files)])
    mu, sd = study.mean(), study.std(ddof=1)
    lim = (mu - SIGMAS * sd, mu + SIGMAS * sd)
    win = window_means(ll)
    res["window"] = win
    res["criteria"]["a"] = dict(
        study=f"{mu:.4f} ± {sd:.4f}", limits=lim, got=win["mean"],
        met=bool(win["mean"] is not None and len(win["steps"]) > 0
                 and lim[0] <= win["mean"] <= lim[1]))

    ev = np.load(os.path.join(artifacts,
                              "al1d_r3_final_eval_seed_variance.npz"))
    own = os.path.join(run_dir, "eval", "al_curves_data_mask.npz")
    if os.path.exists(own):
        f = finals(own)
        res["eval"] = f
        ok, b = True, {}
        for m, key in (("log_prob", "aline_final_ll"),
                       ("rmse", "aline_final_rmse")):
            mu_e, sd_e = float(ev[key].mean()), float(ev[key].std())
            lim_e = (mu_e - SIGMAS * sd_e, mu_e + SIGMAS * sd_e)
            got = f["aline"][m][0]
            better = all((got > f[s][m][0]) if m == "log_prob"
                         else (got < f[s][m][0])
                         for s in ("random", "uncertainty"))
            b[m] = dict(study=f"{mu_e:.4f} ± {sd_e:.4f}", limits=lim_e,
                        got=got, beats_baselines=better)
            ok = ok and lim_e[0] <= got <= lim_e[1] and better
        res["criteria"]["b"] = dict(b, met=bool(ok))
    else:
        res["criteria"]["b"] = dict(met=False, missing=own)

    if demo_eval is not None:
        f = finals(demo_eval)
        res["demo_eval"] = f
        rows = ev["seed8_aline_log_prob"][:, -1]
        ref, ref_se = float(rows.mean()), float(
            rows.std(ddof=1) / np.sqrt(len(rows)))
        got, se, _ = f["aline"]["log_prob"]
        comb = float(np.hypot(se, ref_se))
        res["criteria"]["c"] = dict(
            study_seed8=f"{ref:.4f} ± {ref_se:.4f}", got=f"{got:.4f} ± "
            f"{se:.4f}", sigmas=abs(got - ref) / comb,
            met=bool(abs(got - ref) <= SIGMAS_DEMO * comb))
        if os.path.exists(own):
            res["paired"] = paired(own, demo_eval)
    return res


def paired(run_npz: str, demo_npz: str):
    """The port-trained run minus the JAX-trained demo, row by row, at
    the final step of each aline curve (mean, standard error, rows).
    Two ``eval_al`` calls with the same seed, batch size and device on
    the same task draw the same batches, so the rows pair."""
    out = {}
    with np.load(run_npz) as a, np.load(demo_npz) as b:
        for m in ("log_prob", "rmse"):
            d = a[f"aline_{m}"][:, -1] - b[f"aline_{m}"][:, -1]
            out[m] = (float(d.mean()),
                      float(d.std(ddof=1) / np.sqrt(len(d))), int(len(d)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--demo-eval", default=None,
                    help="eval_al --mask data npz of the JAX demo run")
    ap.add_argument("--artifacts", default="benchmarks/artifacts")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = hold(args.run_dir, args.demo_eval, args.artifacts)
    text = json.dumps(res, default=float)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    missed = [k for k, v in res["criteria"].items() if not v["met"]]
    if missed:
        print(f"missed: {', '.join(missed)}", file=sys.stderr)
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
