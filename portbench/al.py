"""Inputs and checks shared by the active-learning cells."""
from __future__ import annotations

import torch

from portbench import program
from portbench.reference.model import Inputs, load_params, precision
from portbench.reference.rollouts import judge_rollout


def program_batch(d: dict, n_ctx: int, rows=slice(None)):
    """The program's batch of rows ``rows`` of a ``gen.gp_batch``."""
    return program.batch(d["x"][rows], d["y"][rows], d["target_x"][rows],
                         targets_of(d)[rows], d["theta"][rows], n_ctx)


def targets_of(d: dict) -> torch.Tensor:
    """[B, Td + dx + 1, 1]: the data targets, then the GP's latents."""
    return torch.cat([d["target_y"], d["theta"]], dim=1)


def reference_inputs(d: dict, rows, n_theta: int):
    n_target = d["target_y"].shape[1] + n_theta
    mask = torch.ones(n_target, dtype=torch.bool, device=d["x"].device)
    return Inputs(d["x"][rows], d["y"][rows], d["target_x"][rows], n_theta,
                  mask)


def judge(cfg_file: dict, cases, T: int, n_ctx: int, device,
          block: int) -> dict:
    """Judge the program's rollouts: ``cases`` is a list of (batch of
    ``gen.gp_batch``, row indices, strategy, the program's ``idx``,
    ``log_prob`` and ``rmse`` of those rows, on the host).  Returns the
    widest design gap of the ``aline`` and ``uncertainty`` choices, the
    widest gap of the curves, and the count of invalid choices."""
    P = load_params(program.weights_path(cfg_file), device)
    prec = precision(cfg_file["precision"])
    arch = program.arch(cfg_file)
    n_theta = cfg_file["run"]["task"]["n_target_theta"]
    out = dict(design_gap=0.0, uncertainty_gap=0.0, log_prob_gap=0.0,
               rmse_gap=0.0, invalid_choices=0)
    for d, rows, strategy, idx, lp, rmse in cases:
        for a in range(0, len(rows), block):
            r = torch.as_tensor(rows[a:a + block], device=device)
            inp = reference_inputs(d, r, n_theta)
            ctx0 = torch.zeros(inp.x.shape[:2], dtype=torch.bool,
                               device=device)
            ctx0[:, :n_ctx] = True
            targets = targets_of(d)[r][..., 0]
            w = torch.full((targets.shape[1],), 1.0 / targets.shape[1],
                           device=device)
            res = judge_rollout(P, inp, ctx0, targets, w, T,
                                idx[a:a + block].to(device), strategy, prec,
                                arch)
            key = {"aline": "design_gap",
                   "uncertainty": "uncertainty_gap"}.get(strategy)
            if key:
                out[key] = max(out[key], float(res["gap"].max()))
            out["invalid_choices"] += res["invalid"]
            out["log_prob_gap"] = max(out["log_prob_gap"], float(
                (res["log_prob"].cpu() - lp[a:a + block]).abs().max()))
            out["rmse_gap"] = max(out["rmse_gap"], float(
                (res["rmse"].cpu() - rmse[a:a + block]).abs().max()))
    return out
