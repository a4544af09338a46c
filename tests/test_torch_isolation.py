"""The PyTorch port stands alone: no module of ``aline_tpu_torch`` and
nothing in ``chip_smoke.py`` imports JAX, flax, orbax or ``aline_tpu``
(the machine with the GPU has none of them)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "aline_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "aline_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_has_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("aline_tpu_torch", "eval_al.py") in names
    assert len(names) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_package_import(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_rule_names_the_package_exactly():
    assert _forbidden("aline_tpu") and _forbidden("aline_tpu.config")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("aline_tpu_torch.ops.roles")
    assert not _forbidden("torch")


def _below_the_tasks():
    """The kernel layer and the bounds: each task hands its EIG fold to
    them (``Task.fold_eig_chunk``), so none of them names a task."""
    ops = os.path.join(ROOT, "aline_tpu_torch", "ops")
    return sorted([os.path.join(ops, n) for n in os.listdir(ops)
                   if n.endswith(".py")]
                  + [os.path.join(ROOT, "aline_tpu_torch", "eval", "eig.py")])


@pytest.mark.parametrize("path", _below_the_tasks(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_kernels_and_bounds_import_no_task(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m == "aline_tpu_torch.tasks"
                 or m.startswith("aline_tpu_torch.tasks."))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
