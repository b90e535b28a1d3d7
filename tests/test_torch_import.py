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


_PROBE_NEW = r"""
import sys
sys.modules["jax"] = None
import pg_strom_tpu_torch.native as N
import pg_strom_tpu_torch.parallel.mesh, pg_strom_tpu_torch.parallel.shuffle
import pg_strom_tpu_torch.parallel.dist, pg_strom_tpu_torch.parallel.dryrun
import pg_strom_tpu_torch.exec.dist_exec, pg_strom_tpu_torch.models.pg_fixture
print(N.pg_crc32(b"123456789") == 0xCBF43926,
      any(k == "pg_strom_tpu" or k.startswith("pg_strom_tpu.")
          for k in sys.modules))
"""


def test_native_and_parallel_import_without_jax():
    """The subpackages of ROADMAP items 7 and 8 (native/, parallel/) and
    their users import, and the native library builds and answers, with
    jax blocked."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", _PROBE_NEW], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "False"], r.stdout
