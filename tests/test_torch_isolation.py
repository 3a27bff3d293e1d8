"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, so it runs on a machine that has neither installed.

An AST scan of every ``paddle_tpu_torch/**/*.py``, ``chip_smoke.py`` and
``lstm_ab.py`` rejects imports of ``jax``, ``jaxlib``, ``paddle_tpu`` and
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
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "lstm_ab.py")]
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
                 ("models", "transformer.py"), ("models", "resnet.py"),
                 ("paddle_tpu_torch", "io.py"), ("serving", "artifact.py"),
                 ("core", "philox.py"), ("ops", "dropout.py"),
                 ("ops", "control_flow.py"), ("layers", "control_flow.py"),
                 ("paddle_tpu_torch", "clip.py"),
                 ("paddle_tpu_torch", "nets.py"), ("models", "mlp.py"),
                 ("models", "vgg.py"), ("models", "harness.py"),
                 ("models", "decoding.py"), ("ops", "beam_search.py"),
                 ("layers", "compat.py"), ("models", "__init__.py"),
                 ("core", "lod.py"), ("ops", "common.py"),
                 ("ops", "sequence_ops.py"), ("ops", "rnn_ops.py"),
                 ("ops", "lstm_cell.py"), ("layers", "sequence_layers.py"),
                 ("layers", "rnn_layers.py"), ("tools", "op_sweep.py"),
                 ("paddle_tpu_torch", "data_feeder.py"),
                 ("paddle_tpu_torch", "recordio.py"),
                 ("reader", "__init__.py"), ("reader", "device_loader.py"),
                 ("native", "__init__.py"), ("dataset", "common.py"),
                 ("dataset", "cifar.py"),
                 ("paddle_tpu_torch", "profiler.py"),
                 ("paddle_tpu_torch", "transpiler.py"),
                 ("paddle_tpu_torch", "concurrency.py"),
                 ("v2", "trainer.py"), ("v2", "parameters.py"),
                 ("tools", "startup_cost.py")):
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
            "paddle_tpu_torch.models.resnet, paddle_tpu_torch.io, "
            "paddle_tpu_torch.serving.artifact, paddle_tpu_torch.nets, "
            "paddle_tpu_torch.models.decoding, paddle_tpu_torch.models.mlp, "
            "paddle_tpu_torch.models.vgg, paddle_tpu_torch.ops.beam_search, "
            "paddle_tpu_torch.ops.rnn_ops, paddle_tpu_torch.ops.lstm_cell, "
            "paddle_tpu_torch.ops.sequence_ops, "
            "paddle_tpu_torch.tools.op_sweep; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
