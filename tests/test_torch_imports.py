"""The PyTorch port stands alone: no module of ``ahocorasick_rs_tpu_torch``
and neither ``chip_smoke.py`` nor ``profile_main_path.py`` imports ``jax``
or the JAX package (``ahocorasick_rs_tpu``), not even a module of it that
does not use JAX.
Checked on the source text with ``ast``, so a lazy import inside a
function counts too.  The test itself imports both packages, as every
port test file does, to show they load side by side.
"""

from __future__ import annotations

import ast
import importlib
import os

import pytest

import ahocorasick_rs_tpu
import ahocorasick_rs_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("chip_smoke.py", "profile_main_path.py")
FORBIDDEN = {"jax", "jaxlib", "ahocorasick_rs_tpu"}


def _sources() -> list[str]:
    pkg = os.path.dirname(ahocorasick_rs_tpu_torch.__file__)
    out = [os.path.join(ROOT, s) for s in SCRIPTS]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith((".py", ".pyi"))]
    return sorted(out)


def _imported_tops(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
            node.func, "id", getattr(node.func, "attr", "")
        ) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    tops.add(arg.value.split(".")[0])
    return tops


def test_sources_found() -> None:
    paths = _sources()
    for script in SCRIPTS:
        assert os.path.join(ROOT, script) in paths
        assert os.path.exists(os.path.join(ROOT, script)), f"{script} is missing"
    assert len(paths) >= 15
    assert ahocorasick_rs_tpu.__name__ != ahocorasick_rs_tpu_torch.__name__


@pytest.mark.parametrize("module", ["sharded", "multihost"])
def test_parallel_modules_checked(module: str) -> None:
    """The multi-GPU modules are among the checked sources, import
    ``torch.distributed`` and nothing of JAX."""
    path = os.path.join(
        ROOT, "ahocorasick_rs_tpu_torch", "parallel", f"{module}.py"
    )
    assert path in _sources()
    tops = _imported_tops(path)
    assert "torch" in tops and not tops & FORBIDDEN
    mod = importlib.import_module(f"ahocorasick_rs_tpu_torch.parallel.{module}")
    assert "jax" not in vars(mod)


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_import(path: str) -> None:
    bad = _imported_tops(path) & FORBIDDEN
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_public_surface_equals_reference() -> None:
    """The port exports the JAX package's public names, in its order."""
    assert ahocorasick_rs_tpu_torch.__all__ == ahocorasick_rs_tpu.__all__
    for name in ahocorasick_rs_tpu.__all__:
        assert hasattr(ahocorasick_rs_tpu_torch, name), name
    for cls in ("AhoCorasick", "BytesAhoCorasick"):
        assert callable(getattr(getattr(ahocorasick_rs_tpu_torch, cls),
                                "tune"))
