"""The comparison that decides ``correct`` fails what it must: the
control (the reference one precision below the configuration's, in the
program's place), and a run whose timed path is broken underneath (the
look for a card skipped, the rest of the run driven on the CPU at tiny
sizes, the program in float32 so that a sound run reads clean)."""
from __future__ import annotations

import pytest

from portbench_tiny import CELLS, parts, run_tiny
from portbench import control, program
from portbench.harness import checks_from, load_limits


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cf, tr = parts(cell)
    readings = control.CONTROLS[tr["kind"]](cf, tr, program.device("cpu"),
                                            2**31 + 3)
    assert not all(c.ok for c in checks_from(readings, load_limits(cell)))


def test_sound_runs_are_correct():
    for cell in CELLS:
        assert run_tiny(cell, f32=True)[0]["correct"], cell


@pytest.mark.parametrize("cell,fault", [(c, f) for c in control.FAULTS
                                        for f in control.FAULTS[c]])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    control.plant(cell, fault, monkeypatch.setattr)
    res, checks = run_tiny(cell, f32=True)
    assert not res["correct"], res["checks"]
