"""The port's figures (``aline_tpu_torch/make_figures.py`` over
``aline_tpu_torch/utils/plotting.py``) against ``scripts/make_figures.py``.

* On the committed ``benchmarks/artifacts`` files, each of the four
  figures carries the same line data as the script's function on the
  same file: every axes' lines (x, y, label, colour) and every
  ``fill_between`` polygon's vertices, bit for bit.  The script reads
  ``al1d_r4_*_mask.npz``, which is not committed; both sides draw the
  committed ``al1d_r3_*_mask.npz`` under that name.
* ``python -m aline_tpu_torch.make_figures`` draws from the committed
  files on the CPU and writes PNGs to ``--out``; the al1d figure draws
  from an npz that the port's ``eval_al --mask data`` wrote.
* Importing every module of ``aline_tpu_torch`` but ``utils/plotting.py``
  loads no matplotlib.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from aline_tpu.utils import plotting as jplotting  # noqa: E402
from aline_tpu_torch import eval_al, make_figures  # noqa: E402
from aline_tpu_torch.utils import plotting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARTIFACTS = ROOT / "benchmarks" / "artifacts"
# the script's name -> the committed file drawn under it
RENAMED = {"al1d_r4_data_mask.npz": "al1d_r3_data_mask.npz",
           "al1d_r4_theta_mask.npz": "al1d_r3_theta_mask.npz"}


def _script():
    spec = importlib.util.spec_from_file_location(
        "scripts_make_figures", ROOT / "scripts" / "make_figures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Capture:
    """matplotlib.pyplot that keeps every figure the functions close."""

    def __init__(self, plt):
        self._plt, self.figs = plt, []

    def subplots(self, *args, **kwargs):
        fig, axes = self._plt.subplots(*args, **kwargs)
        self.figs.append(fig)
        return fig, axes

    def close(self, fig):
        pass

    def __getattr__(self, name):
        return getattr(self._plt, name)


def _artifacts(tmp_path):
    art = tmp_path / "artifacts"
    art.mkdir()
    for name in make_figures.DEFAULTS.values():
        os.symlink(ARTIFACTS / RENAMED.get(name, name), art / name)
    return art


def _line_data(fig):
    out = []
    for ax in fig.axes:
        lines = [(ln.get_label(), ln.get_color(), np.asarray(ln.get_xdata()),
                  np.asarray(ln.get_ydata())) for ln in ax.get_lines()]
        polys = [p.vertices for c in ax.collections
                 for p in c.get_paths()]
        out.append((lines, polys))
    return out


def test_figures_carry_the_scripts_line_data(tmp_path, monkeypatch):
    art = _artifacts(tmp_path)
    script = _script()
    monkeypatch.setattr(script, "ART", str(art))
    want_plt = Capture(jplotting.plt)
    jplotting.apply_style()
    (tmp_path / "jax").mkdir()
    for fn in (script.fig_loc_spce, script.fig_psych_psi, script.fig_hpo,
               script.fig_al1d):
        fn(want_plt, jplotting.PALETTE, str(tmp_path / "jax"))
    got_plt = Capture(plotting.plt)
    monkeypatch.setattr(plotting, "plt", got_plt)
    written = make_figures.main(["--artifacts", str(art), "--out",
                                 str(tmp_path / "port")])
    assert [Path(p).name for p in written] == [
        "loc_spce.png", "psych_psi.png", "hpo_svm.png", "al1d_split.png"]
    assert len(got_plt.figs) == len(want_plt.figs) == 4
    for got, want in zip(got_plt.figs, want_plt.figs):
        g, w = _line_data(got), _line_data(want)
        assert len(g) == len(w)
        for (gl, gp), (wl, wp) in zip(g, w):
            assert len(gl) == len(wl) > 0 and len(gp) == len(wp) > 0
            for a, b in zip(gl, wl):
                assert a[:2] == b[:2]
                assert np.array_equal(a[2], b[2])
                assert np.array_equal(a[3], b[3])
            for a, b in zip(gp, wp):
                assert np.array_equal(a, b)
    for p in written:
        assert Path(p).stat().st_size > 0


def test_cli_draws_from_committed_and_port_files(tmp_path):
    run = tmp_path / "demo"
    run.mkdir()
    (run / "config.json").write_text(
        (ROOT / "checkpoints" / "al1d_5k_demo" / "config.json").read_text())
    eval_al.main([str(run), "--device", "cpu", "--batch-size", "2", "--T",
                  "2", "--n-query", "8", "--mask", "data"])
    data_npz = run / "eval" / "al_curves_data_mask.npz"
    assert data_npz.exists()
    out = tmp_path / "figs"
    proc = subprocess.run(
        [sys.executable, "-m", "aline_tpu_torch.make_figures",
         "--artifacts", str(ARTIFACTS), "--out", str(out),
         "--al1d-data", str(data_npz)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in out.glob("*.png")) == [
        "al1d_split.png", "hpo_svm.png", "loc_spce.png", "psych_psi.png"]


def test_importing_the_port_loads_no_matplotlib():
    code = ("import pkgutil, importlib, sys, aline_tpu_torch\n"
            "for m in pkgutil.walk_packages(aline_tpu_torch.__path__,"
            " 'aline_tpu_torch.'):\n"
            "    if m.name != 'aline_tpu_torch.utils.plotting':\n"
            "        importlib.import_module(m.name)\n"
            "assert 'aline_tpu_torch.make_figures' in sys.modules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'matplotlib' or m == 'aline_tpu_torch.utils.plotting']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
