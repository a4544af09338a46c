"""Plotting utilities for analysis scripts (the port's copy of
``aline_tpu/utils/plotting.py``).

Capability parity with the reference plotting stack
(reference: utils/plot_config.py:1-165 style config,
utils/gp_active_learning.py:258-570 GP/AL visualization).  All functions
degrade to no-ops when matplotlib is unavailable.  matplotlib is imported
here only, with the Agg backend; no other module of the package imports
this one when it is imported itself (``make_figures`` does so in
``main``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover
    plt = None

PALETTE = ["#4C72B0", "#DD8452", "#55A868", "#C44E52", "#8172B3",
           "#937860", "#DA8BC3", "#8C8C8C"]


def apply_style(use_tex: bool = False) -> None:
    """Publication style (reference: utils/plot_config.py apply_style)."""
    if plt is None:
        return
    plt.rcParams.update({
        "figure.dpi": 120,
        "font.size": 11,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "axes.grid": True,
        "grid.alpha": 0.25,
        "legend.frameon": False,
        "text.usetex": use_tex,
    })


def plot_al_curves(curves: Dict[str, np.ndarray], metric: str = "rmse",
                   save_path: Optional[str] = None, title: str = ""):
    """Per-step AL curves with mean ± standard error bands.

    Args:
        curves: {strategy: [B, T+1] array} (e.g. from compare_strategies).
    """
    if plt is None:
        return None
    apply_style()
    fig, ax = plt.subplots(figsize=(5, 3.4))
    for i, (name, arr) in enumerate(sorted(curves.items())):
        arr = np.asarray(arr)
        steps = np.arange(arr.shape[1])
        mean = arr.mean(0)
        se = arr.std(0) / np.sqrt(arr.shape[0])
        c = PALETTE[i % len(PALETTE)]
        ax.plot(steps, mean, label=name, color=c)
        ax.fill_between(steps, mean - se, mean + se, alpha=0.2, color=c)
    ax.set_xlabel("acquisition step")
    ax.set_ylabel(metric)
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
    return fig


def plot_eig_bounds(pce_mean: np.ndarray, pce_err: np.ndarray,
                    nmc_mean: np.ndarray, nmc_err: np.ndarray,
                    save_path: Optional[str] = None, title: str = ""):
    """Stepwise sPCE/sNMC bound bracket."""
    if plt is None:
        return None
    apply_style()
    fig, ax = plt.subplots(figsize=(5, 3.4))
    steps = np.arange(1, len(pce_mean) + 1)
    ax.errorbar(steps, pce_mean, yerr=pce_err, label="sPCE (lower)",
                color=PALETTE[0], capsize=2)
    ax.errorbar(steps, nmc_mean, yerr=nmc_err, label="sNMC (upper)",
                color=PALETTE[1], capsize=2)
    ax.fill_between(steps, pce_mean, nmc_mean, alpha=0.12,
                    color=PALETTE[0])
    ax.set_xlabel("experiment step")
    ax.set_ylabel("EIG bound (nats)")
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
    return fig


def plot_gp_1d_posterior(x_ctx, y_ctx, x_grid, mean, std,
                         x_query: Optional[np.ndarray] = None,
                         scores: Optional[np.ndarray] = None,
                         save_path: Optional[str] = None, title: str = ""):
    """1-D GP posterior with context points and optional acquisition
    scores (reference: utils/gp_active_learning.py:258-400)."""
    if plt is None:
        return None
    apply_style()
    fig, ax = plt.subplots(figsize=(5.4, 3.4))
    x_grid = np.asarray(x_grid).reshape(-1)
    order = np.argsort(x_grid)
    ax.plot(x_grid[order], np.asarray(mean).reshape(-1)[order],
            color=PALETTE[0], label="posterior mean")
    m = np.asarray(mean).reshape(-1)[order]
    s = np.asarray(std).reshape(-1)[order]
    ax.fill_between(x_grid[order], m - 2 * s, m + 2 * s, alpha=0.2,
                    color=PALETTE[0], label="±2σ")
    ax.scatter(np.asarray(x_ctx).reshape(-1), np.asarray(y_ctx).reshape(-1),
               color="k", zorder=5, s=18, label="context")
    if x_query is not None and scores is not None:
        ax2 = ax.twinx()
        ax2.spines["right"].set_visible(True)
        xq = np.asarray(x_query).reshape(-1)
        oq = np.argsort(xq)
        ax2.plot(xq[oq], np.asarray(scores).reshape(-1)[oq],
                 color=PALETTE[3], alpha=0.6, lw=1.0, label="acquisition")
        ax2.set_ylabel("acquisition score", color=PALETTE[3])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if title:
        ax.set_title(title)
    ax.legend(loc="best")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
    return fig
