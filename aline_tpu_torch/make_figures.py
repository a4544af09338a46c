"""Headline figures from eval npz files (the port of
``scripts/make_figures.py``), drawn headless on the CPU with matplotlib.

    python -m aline_tpu_torch.make_figures [--artifacts benchmarks/artifacts]
        [--out docs/figures] [--loc-policy NPZ] [--loc-random NPZ]
        [--psych-policy NPZ] [--psych-psi NPZ] [--hpo NPZ]
        [--al1d-data NPZ] [--al1d-theta NPZ]

Four figures, each from its npz files, read with the keys that the port's
entry points write (the same as the JAX scripts'):

* ``loc_spce.png``: ``eval_bed``'s bounds (``pce_*``, ``nmc_*``) of the
  policy and ``random_pce_*``, ``random_nmc_*`` of the random designs
  (both may be one ``--with-random-baseline`` file);
* ``psych_psi.png``: ``eval_psychometric``'s and ``eval_psi``'s curves
  (threshold-slope mask);
* ``hpo_svm.png``: ``eval_hpo``'s test curves;
* ``al1d_split.png``: ``eval_al --mask data`` and ``--mask theta``
  (``al_curves_<mask>_mask.npz``); one of the two is enough.

A path left out defaults to ``scripts/make_figures.py``'s file name under
``--artifacts``; a figure whose files are missing is skipped.  Needs
matplotlib (``utils/plotting.py``), which the card's machine lacks.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

# scripts/make_figures.py's artifact names
DEFAULTS = {"loc_policy": "loc_r4_100k_N2000_T35_L1e6.npz",
            "loc_random": "loc_r3_random_N2000_T35_L1e6.npz",
            "psych_policy": "psych_r4_100k_curves.npz",
            "psych_psi": "psych_psi_curves.npz",
            "hpo": "hpo_r4_svm_test_curves.npz",
            "al1d_data": "al1d_r4_data_mask.npz",
            "al1d_theta": "al1d_r4_theta_mask.npz"}


def _load(path):
    return dict(np.load(path)) if path and os.path.exists(path) else None


def _pool_seeds(d, key):
    """[B, T+1] curves of every eval seed, concatenated: the first seed
    unprefixed, later ones as ``seed<N>_``, by value."""
    pres = [""] + sorted({m.group(0) for k in d
                          if (m := re.match(r"seed\d+_", k))})
    parts = [d[f"{p}{key}"] for p in pres if f"{p}{key}" in d]
    return np.concatenate(parts) if parts else None


def _band(ax, curves, label, color):
    mean = curves.mean(0)
    se = curves.std(0) / np.sqrt(curves.shape[0])
    steps = np.arange(curves.shape[1])
    ax.plot(steps, mean, label=label, color=color)
    ax.fill_between(steps, mean - se, mean + se, color=color, alpha=0.2)


def _save(plt, fig, out, name):
    fig.tight_layout()
    path = os.path.join(out, name)
    fig.savefig(path)
    plt.close(fig)
    print(f"wrote {name}")
    return path


def fig_loc_spce(plt, palette, out, policy_npz, random_npz):
    pol, rnd = _load(policy_npz), _load(random_npz)
    if pol is None or rnd is None:
        return None
    fig, ax = plt.subplots(figsize=(5.2, 3.4))
    for d, pre, label, c in ((pol, "", "ALINE policy (100k)", palette[0]),
                             (rnd, "random_", "random designs", palette[1])):
        pce_m, pce_e = d[f"{pre}pce_mean"], d[f"{pre}pce_err"]
        steps = np.arange(1, len(pce_m) + 1)
        ax.plot(steps, pce_m, label=f"{label} sPCE", color=c)
        ax.fill_between(steps, pce_m - pce_e, pce_m + pce_e, color=c,
                        alpha=0.25)
        ax.plot(steps, d[f"{pre}nmc_mean"], color=c, ls="--", alpha=0.6,
                label=f"{label} sNMC")
    ax.set_xlabel("experiment step")
    ax.set_ylabel("EIG bound (nats)")
    ax.set_title("Location finding, T=35, L=1e6, M=2000")
    ax.legend(fontsize=8)
    return _save(plt, fig, out, "loc_spce.png")


def fig_psych_psi(plt, palette, out, policy_npz, psi_npz):
    pol, psi = _load(policy_npz), _load(psi_npz)
    if pol is None or psi is None:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(8.6, 3.4))
    mask = "threshold_slope"
    for ax, metric, ylabel in ((axes[0], "log_prob",
                                "targeted log-likelihood"),
                               (axes[1], "rmse", "targeted RMSE")):
        _band(ax, _pool_seeds(pol, f"{mask}_{metric}"),
              "ALINE policy (amortized)", palette[0])
        _band(ax, _pool_seeds(psi, f"{mask}_psi_{metric}"),
              "QUEST+/PSI (grid Bayes)", palette[2])
        _band(ax, _pool_seeds(psi, f"{mask}_random_{metric}"),
              "random designs (grid Bayes)", palette[1])
        ax.set_xlabel("trial")
        ax.set_ylabel(ylabel)
    axes[0].legend(fontsize=8)
    fig.suptitle("Psychometric threshold+slope targets, 300 subjects")
    return _save(plt, fig, out, "psych_psi.png")


def fig_hpo(plt, palette, out, curves_npz):
    d = _load(curves_npz)
    if d is None:
        return None
    fig, ax = plt.subplots(figsize=(5.2, 3.4))
    for strat, c in (("aline", palette[0]), ("random", palette[1]),
                     ("uncertainty", palette[3])):
        _band(ax, _pool_seeds(d, f"{strat}_log_prob"), strat, c)
    ax.set_xlabel("acquisition step")
    ax.set_ylabel("test log-likelihood")
    ax.set_title("HPO-B svm surrogate, fixed-BO-init test protocol")
    ax.legend(fontsize=8)
    return _save(plt, fig, out, "hpo_svm.png")


def fig_al1d(plt, palette, out, data_npz, theta_npz):
    """GP-AL-1D curves under the data and the theta target masks."""
    fig, axes = plt.subplots(1, 2, figsize=(8.6, 3.4))
    found = False
    for ax, mask, path in ((axes[0], "data", data_npz),
                           (axes[1], "theta", theta_npz)):
        d = _load(path)
        if d is None:
            continue
        found = True
        for strat, c in (("aline", palette[0]), ("random", palette[1]),
                         ("uncertainty", palette[3])):
            cur = _pool_seeds(d, f"{strat}_log_prob")
            if cur is not None:
                _band(ax, cur, strat, c)
        ax.set_xlabel("acquisition step")
        ax.set_ylabel(f"{mask}-mask log-likelihood")
    if not found:
        plt.close(fig)
        return None
    axes[0].legend(fontsize=8)
    fig.suptitle("GP-AL-1D, split-mask objectives")
    return _save(plt, fig, out, "al1d_split.png")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="benchmarks/artifacts",
                    help="directory of the default npz files")
    ap.add_argument("--out", default="docs/figures")
    for key in DEFAULTS:
        ap.add_argument(f"--{key.replace('_', '-')}", default=None,
                        help=f"default: ARTIFACTS/{DEFAULTS[key]}")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    paths = {k: getattr(args, k) or os.path.join(args.artifacts, name)
             for k, name in DEFAULTS.items()}
    from aline_tpu_torch.utils.plotting import PALETTE, apply_style, plt
    if plt is None:
        sys.exit("matplotlib unavailable")
    apply_style()
    os.makedirs(args.out, exist_ok=True)
    return [p for p in (
        fig_loc_spce(plt, PALETTE, args.out, paths["loc_policy"],
                     paths["loc_random"]),
        fig_psych_psi(plt, PALETTE, args.out, paths["psych_policy"],
                      paths["psych_psi"]),
        fig_hpo(plt, PALETTE, args.out, paths["hpo"]),
        fig_al1d(plt, PALETTE, args.out, paths["al1d_data"],
                 paths["al1d_theta"])) if p is not None]


if __name__ == "__main__":
    main()
