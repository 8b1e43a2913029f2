"""The import rule: nothing the benchmark runs on the card loads JAX or
the JAX package, compared by whole top-level names, and the reference
loads nothing of the program."""
import ast
import os
import sys

import harness
import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SIDE = {"jax", "jaxlib", "flax", "mrhash_tpu"}


def sources():
    for d, _, files in os.walk(BENCH_DIR):
        if os.sep + "tests" in d[len(BENCH_DIR):] or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_side():
    bad = {p: sorted(set(top_level_imports(p)) & JAX_SIDE)
           for p in sources()}
    assert not {p: b for p, b in bad.items() if b}
    ref = os.path.join(BENCH_DIR, "reference")
    for p in sources():
        if p.startswith(ref):
            assert "mrhash_tpu_torch" not in set(top_level_imports(p)), p


@pytest.mark.parametrize("name,found", [
    ("mrhash_tpu_torch.geowrapper", []), ("mrhash_tpu_torchx", []),
    ("mrhash_tpu.ops", ["mrhash_tpu"]), ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"])])
def test_runtime_check_compares_whole_names(monkeypatch, name, found):
    for m in list(sys.modules):
        if m.split(".")[0] in JAX_SIDE:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == found
