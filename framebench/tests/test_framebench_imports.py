"""Nothing under framebench/ imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (``vkrt_tpu_torch`` begins with ``vkrt_tpu``)."""

import ast
import glob
import os
import sys

import pytest

from framebench.run import FORBIDDEN, loaded_forbidden

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_imports(path):
    names = _top_names(path)
    assert not names & {"jax", "jaxlib", "flax", "vkrt_tpu"}
    if os.sep + "reference" + os.sep in path:
        assert "vkrt_tpu_torch" not in names


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vkrt_tpu_torch_fake", object())
    assert "vkrt_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "vkrt_tpu.fake", object())
    assert "vkrt_tpu" in loaded_forbidden()
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "vkrt_tpu"}


def test_orbit_run_loads_no_jax(tiny_root):
    """A whole run of the denoised orbit cell, in a process of its own,
    leaves neither JAX nor the JAX package in ``sys.modules``."""
    import subprocess

    code = ("import sys; from framebench.cells import resolve; "
            "from framebench.run import loaded_forbidden, run_cell; "
            f"cell = resolve('cityorbit.hybrid-denoised-orbit', root={tiny_root!r}); "
            "res = run_cell(cell, 5, 0.0, False, 'cpu', log=lambda *a: None); "
            "print(res['correct'], loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["True", "[]"], out.stdout
