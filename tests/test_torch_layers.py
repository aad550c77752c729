"""The port's layers import downward only.

Every module of a layer is parsed and each of its imports read, those
inside functions included: utils/ imports nothing of the port outside
utils/, and ops/, render/ and models/ import neither tools/ (the probes and
demos) nor app/ (the CLI and the preview). The file imports neither JAX nor
the port.
"""
import ast
import os

import pytest

PKG = "project3_cuda_path_tracer_tpu_torch"
ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), PKG)

# layer -> the subpackages of the port it may not import (None: every one
# but its own)
FORBIDDEN = {"utils": None, "ops": ("tools", "app"),
             "render": ("tools", "app"), "models": ("tools", "app")}


def _modules(layer: str):
    """(path, dotted name) of every module of the layer."""
    for dirpath, _, files in os.walk(os.path.join(ROOT, layer)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]), ROOT)
                yield (os.path.join(dirpath, f),
                       ".".join([PKG] + rel.split(os.sep)))


def _imports(path: str, module: str):
    """(line, dotted name) of every import in the module, relative ones
    resolved against its package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    package = module if path.endswith("__init__.py") else \
        module.rsplit(".", 1)[0]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - (node.level - 1)]
                base = ".".join(parts + ([node.module] if node.module
                                         else []))
            if node.module:
                yield node.lineno, base
            else:
                for alias in node.names:
                    yield node.lineno, f"{base}.{alias.name}"


@pytest.mark.parametrize("layer", sorted(FORBIDDEN))
def test_layer_imports_point_down(layer):
    modules = list(_modules(layer))
    assert modules, f"no modules under {layer}/"
    bad = []
    for path, module in modules:
        for line, name in _imports(path, module):
            if name != PKG and not name.startswith(PKG + "."):
                continue
            sub = name.split(".")[1] if "." in name else ""
            forbidden = FORBIDDEN[layer]
            if (sub != layer) if forbidden is None else (sub in forbidden):
                bad.append(f"{os.path.relpath(path, ROOT)}:{line} {name}")
    assert not bad, bad
