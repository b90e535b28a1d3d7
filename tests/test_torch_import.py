"""The PyTorch port imports without JAX.

`import pg_strom_tpu` imports jax (pg_strom_tpu/__init__.py), so the port
copies the host-only modules instead of importing them.  This test imports
every module of pg_strom_tpu_torch in a fresh interpreter where importing
jax raises, and checks that no jax module was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import pg_strom_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pg_strom_tpu_torch.__path__,
                                               "pg_strom_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and (k == "jax" or k.startswith("jax.")
                                      or k.startswith("jaxlib")
                                      or k.startswith("pg_strom_tpu.")
                                      or k == "pg_strom_tpu"))
print(len(names), loaded)
"""


def test_port_imports_every_module_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    count, loaded = r.stdout.strip().split(" ", 1)
    assert int(count) >= 20, r.stdout
    assert loaded == "[]", loaded
