"""The reference agrees with the port on the CPU at tiny sizes, for each
cell's traffic: in float32 on both sides to rounding, and in the
configuration's bfloat16 under the cell's committed limits."""
from __future__ import annotations

import pytest

from portbench_tiny import CELLS, parts, run_tiny
from portbench import run as R

F32_LIMIT = {"loss_gap": 1e-3, "design_gap": 1e-4, "first_predict_gap": 1e-3,
             "change_gap": 1e-2, "uncertainty_gap": 1e-4,
             "log_prob_gap": 1e-4, "rmse_gap": 1e-4, "invalid_choices": 0,
             "history_mismatch": 0, "pce_gap": 1e-4, "nmc_gap": 1e-4}


@pytest.mark.parametrize("cell", CELLS)
def test_float32_agrees(cell):
    res, checks = run_tiny(cell, f32=True)
    assert res["attempted"] >= 1
    for c in checks:
        assert c.value <= F32_LIMIT[c.name], (c.name, c.value)


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_within_the_limits(cell):
    cf, tr = parts(cell)
    if tr["kind"] == "train_epochs":
        # a tiny batch's reward normalisation sends later steps apart on
        # rounding alone: the first step is held here
        tr["checked_steps"] = 1
    res, checks = R.execute(cell, 2**31 + 977, 0.3, False, "cpu",
                            config=cf, traffic=tr)
    assert res["correct"], res["checks"]
