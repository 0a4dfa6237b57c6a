"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, nor any third-party
package the card's machine lacks (it has torch, numpy, scipy, einops and
triton, and no networkx), and importing the port builds no kernel."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}
#: the third-party packages the card's machine has; ``triton`` only inside
#: the functions that launch a kernel
THIRD_PARTY = {"torch", "numpy", "scipy", "einops", "triton"}

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
build = "repro_torch.kernels._build"
for name in names:
    if name != build:
        importlib.import_module(name)
built = build in sys.modules
importlib.import_module(build)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"names": names, "bad": bad, "build_imported": built}))
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["names"]) >= 15, got
    # the search and the corpus, every module of both
    for pkg in ("search", "corpus"):
        want = {f"repro_torch.{pkg}.{p.stem}"
                for p in (PORT / pkg).glob("*.py") if p.stem != "__init__"}
        assert want and want <= set(got["names"]), got["names"]
    assert "repro_torch.core.explorer" in got["names"]
    assert got["bad"] == [], got
    # the wrappers build and load kernels only when they launch one
    assert not got["build_imported"], got


def _imports(path):
    """(top-level package, at module level) of every absolute import, those
    inside functions included."""
    tree = ast.parse(path.read_text(), str(path))
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], id(node) in top


def _imported_roots(path):
    return {root for root, _ in _imports(path)}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_nothing_of_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & FORBIDDEN, f"{path.name} imports {roots & FORBIDDEN}"


def test_lazy_imports_name_the_port():
    """Imports inside functions (the reference's search has them:
    ``engine.py`` and ``pool.py`` import ``repro.analysis`` lazily) name
    the port and never ``repro`` or ``jax``."""
    lazy = {}
    for path in sorted(PORT.rglob("*.py")):
        roots = {root for root, at_top in _imports(path) if not at_top}
        assert not roots & FORBIDDEN, f"{path.name} imports {roots} lazily"
        lazy[str(path.relative_to(PORT))] = roots
    for name in ("search/engine.py", "search/pool.py"):
        assert "repro_torch" in lazy[name], lazy[name]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_only_what_the_card_machine_has(path):
    """No import, lazy ones included, of a package outside the standard
    library and the card machine's list (networkx above all: the reference's
    balancer runs on it); ``triton`` never at module level."""
    own = {"repro_torch"}
    for root, at_top in _imports(path):
        if root in sys.stdlib_module_names or root in own:
            continue
        assert root in THIRD_PARTY, f"{path.name} imports {root}"
        assert not (root == "triton" and at_top), \
            f"{path.name} imports triton at module level"
