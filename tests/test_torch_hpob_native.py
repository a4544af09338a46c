"""The port's native HPO-B loader (``aline_tpu_torch/tasks/hpob_native.py``
over ``aline_tpu_torch/csrc/hpob_loader.cpp``).

* On each of the six meta-train files that ``HPOB`` opens, the native
  arrays, the port's ``json`` arrays and ``aline_tpu/tasks/hpob_native.py``'s
  ``json`` path are equal bit for bit, with equal dtypes, shapes and
  dataset order.
* The extension is built with ``g++`` into ``aline_tpu_torch/build/``
  under a name that carries a hash of its source.
* A source that does not compile raises with the compiler's output; it
  does not fall back to ``json``.
* ``HPOB`` reads through the native loader.
"""
import numpy as np
import pytest

from aline_tpu.tasks import hpob_native as jhn
from aline_tpu_torch.ops import _build
from aline_tpu_torch.tasks import hpo, hpob_native
from aline_tpu_torch.tasks.hpo import DATA_DIR, HPOB

METAS = ("glmnet", "ranger", "ranger_shift", "rpart", "svm", "xgboost")


def _assert_same(got, want):
    assert list(got) == list(want)
    for did in want:
        for g, w in zip(got[did], want[did]):
            assert g.dtype == w.dtype == np.float32
            assert g.shape == w.shape
            assert np.array_equal(g, w), did


@pytest.mark.parametrize("meta", METAS)
def test_native_equals_json_and_jax(meta, monkeypatch):
    path = str(DATA_DIR / "HPOB" / f"{meta}.json")
    native = hpob_native.load_hpob_arrays(path)
    plain = hpob_native.load_hpob_arrays(path, native=False)
    monkeypatch.setattr(jhn, "_NATIVE", False)     # the JAX json path
    jax_json = jhn.load_hpob_arrays(path)
    _assert_same(native, plain)
    _assert_same(native, jax_json)
    assert all(y.shape[1] == 1 for _, y in native.values())


def test_built_into_build_dir_under_source_hash():
    path = _build.build_host(hpob_native.EXTENSION)
    assert path.parent == _build.BUILD_DIR
    assert path == _build.host_library_path(hpob_native.EXTENSION)
    assert path.name.startswith("hpob_loader-") and path.exists()
    assert hpob_native.native_available()


def test_broken_source_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    good = (_build.CSRC_DIR / "hpob_loader.cpp").read_text()
    (csrc / "hpob_loader.cpp").write_text(good + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = str(DATA_DIR / "HPOB" / "rpart.json")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for hpob_loader"):
        hpob_native.load_hpob_arrays(path)
    assert not hpob_native.native_available()
    assert not list((tmp_path / "build").glob("*.so"))
    # the json path stays explicit and works
    assert hpob_native.load_hpob_arrays(path, native=False)


def test_hpob_reads_through_the_loader(monkeypatch):
    calls = []
    real = hpo.load_hpob_arrays

    def spy(path, native=True):
        calls.append(native)
        return real(path, native=native)

    monkeypatch.setattr(hpo, "load_hpob_arrays", spy)
    a = HPOB("svm")
    assert calls == [True]
    want = hpob_native.load_hpob_arrays(
        str(DATA_DIR / "HPOB" / "svm.json"), native=False)
    assert a.dataset_ids == list(want)
    for did, (X, y) in want.items():
        assert np.array_equal(a._X[did], X)
        assert np.array_equal(a._y[did], y)
