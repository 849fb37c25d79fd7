"""The port stands alone: it imports neither JAX nor the JAX package.

The import check runs in a fresh interpreter, because this test process
(through tests/conftest.py) has already imported both.
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dlrover_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dlrover_tpu")

ENTRY_POINTS = """
import sys
import dlrover_tpu_torch.examples.train_llama
import dlrover_tpu_torch.interop
import dlrover_tpu_torch.ops.kernel_build
import dlrover_tpu_torch.trainer.data
import dlrover_tpu_torch.trainer.executor
import dlrover_tpu_torch.trainer.failover
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(",".join(bad))
"""


def test_entry_points_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", ENTRY_POINTS.format(forbidden=FORBIDDEN)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_module_names_a_forbidden_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    offenders = {
        os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                         & set(FORBIDDEN))
        for f in files
    }
    assert {f: m for f, m in offenders.items() if m} == {}
