"""The port imports no JAX or flax: every proqa_tpu_torch module imports in a
fresh interpreter where `import jax` and `import flax` fail."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["flax"] = None
import proqa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(proqa_tpu_torch.__path__, "proqa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15  # every module was found
