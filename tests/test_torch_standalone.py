"""The port stands on its own: ``seeksv_tpu_torch`` and ``chip_smoke.py``
import torch, numpy and the standard library, and nothing of the JAX
package ``seeksv_tpu`` nor of jax.

Two checks: every module of the port imports, and the small ``run`` slice
of tests/test_torch_pipeline.py runs on the CPU, in a process whose
import system refuses ``seeksv_tpu``, ``seeksv_tpu.*``, ``jax`` and
``jaxlib`` (``seeksv_tpu_torch`` is another name and is let through); and
a scan of the sources for any import, ``importlib`` / ``exec`` / ``open``
or path that names the JAX package."""
import ast
import gzip
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seeksv_tpu_torch")

MODULES = sorted(
    m.name for m in pkgutil.walk_packages([PKG], "seeksv_tpu_torch.")
    if not m.name.endswith("__main__"))

_REFUSE = """
import sys
REFUSED = ("seeksv_tpu", "jax", "jaxlib")
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
def _loaded():
    return [m for m in sys.modules if m.split(".")[0] in REFUSED]
for m in _loaded():
    del sys.modules[m]
sys.meta_path.insert(0, _Refuse())
"""

_IMPORT_ALL = _REFUSE + """
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
assert not _loaded(), _loaded()
try:
    import seeksv_tpu
except ImportError:
    print("IMPORTED", len(sys.argv) - 1)
"""

_RUN = _REFUSE + """
import runpy
sys.argv = ["seeksv_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("seeksv_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
assert not _loaded(), _loaded()
from seeksv_tpu_torch.io import native
from seeksv_tpu_torch.ops import extend, global_device
assert extend.PLAIN_CALLS["extend_left"] > 0, extend.PLAIN_CALLS
assert min(global_device.PLAIN_CALLS.values()) > 0, global_device.PLAIN_CALLS
print("NATIVE", native.library_path())
print("STANDALONE_OK")
"""


def _env(home):
    return dict(os.environ, HOME=str(home), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [REPO] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]))


def test_every_module_imports_with_the_jax_package_refused(tmp_path):
    assert len(MODULES) > 30, MODULES
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, *MODULES],
                         cwd=str(tmp_path), env=_env(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"IMPORTED {len(MODULES)}" in out.stdout


def test_slice_runs_with_the_jax_package_refused(tmp_path):
    """`python -m seeksv_tpu_torch run --device cpu` with ``seeksv_tpu``
    and jax refused writes what the JAX package's run writes, with the
    native host library loaded from the port's own build directory."""
    paths = build_dataset(str(tmp_path / "ds"), 300_000, 10, 1000, 1, 2,
                          False, virus_kb=60, virus_events=20,
                          virus_div=0.04)
    jax_run_pipeline(paths["ref_fa"], paths["bam"], str(tmp_path / "jax"))
    out = subprocess.run(
        [sys.executable, "-c", _RUN, "run", "--device", "cpu", "-o",
         str(tmp_path / "alone"), paths["ref_fa"], paths["bam"]],
        cwd=str(tmp_path), env=_env(tmp_path), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "STANDALONE_OK" in out.stdout
    lib = re.search(r"^NATIVE (.*)$", out.stdout, re.M).group(1)
    assert lib.startswith(os.path.join(REPO, "build", "seeksv_tpu_torch",
                                       "native") + os.sep), lib
    for suffix in ("clip.sam", "sv"):
        with open(tmp_path / f"alone.{suffix}", "rb") as a, \
                open(tmp_path / f"jax.{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix
    for suffix in ("clip.gz", "clip.fq.gz"):
        with gzip.open(tmp_path / f"alone.{suffix}") as a, \
                gzip.open(tmp_path / f"jax.{suffix}") as b:
            assert a.read() == b.read(), suffix


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return sorted(files)


# the JAX package by name, not the port's (seeksv_tpu_torch)
_NAME = re.compile(r"\bseeksv_tpu\b(?!_torch)")
# "file:line" of a counterpart, as chip_smoke.py's record of the kernels
# reports it ("replaces"): names a line, cannot be imported or opened
_POINTER = re.compile(r"seeksv_tpu/[\w/]+\.py:\d+")


def _code_strings_and_imports(path):
    """(imported module names, string constants that are no docstring)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                docstrings.add(id(body[0].value))
    imports, strings = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imports += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imports.append(node.module or "")
        elif isinstance(node, ast.Constant) and isinstance(
                node.value, str) and id(node) not in docstrings:
            strings.append(node.value)
    return imports, strings


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_the_jax_package_only_in_comments(path):
    """No import of ``seeksv_tpu`` or jax, and no string outside a
    docstring (a module name handed to importlib, a path that is opened
    or executed, a subprocess argument) that names ``seeksv_tpu``: the
    name may stand only in comments and docstrings that point a reader
    at a counterpart, and in a "file:line" pointer that is printed."""
    if not path.endswith(".py"):
        with open(path) as f:
            code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
        assert not _NAME.search(code), path
        return
    imports, strings = _code_strings_and_imports(path)
    bad = [m for m in imports
           if m.split(".")[0] in ("seeksv_tpu", "jax", "jaxlib")]
    assert not bad, f"{path} imports {bad}"
    named = [s for s in strings
             if _NAME.search(s) and not _POINTER.fullmatch(s)]
    assert not named, f"{path} names the JAX package in code: {named}"
