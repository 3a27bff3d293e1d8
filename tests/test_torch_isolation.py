"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, so it runs on a machine that has neither installed.

An AST scan of every ``paddle_tpu_torch/**/*.py`` and ``chip_smoke.py``
rejects imports of ``jax``, ``jaxlib``, ``paddle_tpu`` and
``paddle_tpu.*`` (``paddle_tpu_torch`` itself is allowed), and a fresh
interpreter importing the port's serving package must not load jax.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "paddle_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "paddle_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _banned(module):
    top = module.split(".")[0]
    return top in BANNED


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_scan_covers_the_port():
    srcs = _sources()
    assert os.path.join(ROOT, "chip_smoke.py") in srcs
    for tail in (("serving", "engine.py"), ("serving", "spec.py"),
                 ("serving", "sampling.py"), ("core", "executor.py"),
                 ("ops", "flash_attention.py"),
                 ("ops", "matmul_stats.py"), ("ops", "conv.py"),
                 ("models", "transformer.py"), ("models", "resnet.py")):
        assert any(p.endswith(os.path.join(*tail)) for p in srcs), tail


@pytest.mark.parametrize("module, banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("paddle_tpu", True), ("paddle_tpu.serving.kvpool", True),
    ("paddle_tpu_torch", False), ("paddle_tpu_torch.ops", False),
    ("torch", False)])
def test_rule(module, banned):
    assert _banned(module) is banned


def test_no_banned_imports():
    bad = ["%s:%d imports %s" % (os.path.relpath(p, ROOT), line, mod)
           for p in _sources() for line, mod in _imports(p)
           if _banned(mod)]
    assert not bad, "\n".join(bad)


def test_import_leaves_jax_unloaded():
    code = ("import sys, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.transformer_infer, "
            "paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.models.resnet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
