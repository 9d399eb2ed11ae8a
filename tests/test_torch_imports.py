"""The port stands alone: every ``repro_torch`` module, and
``chip_smoke.py``, import with JAX blocked, the JAX package ``repro``
refused and ``cloudpickle`` blocked (the GPU machine has none; only a
cross-process run of the ``multiproc`` transport needs it), in a
subprocess, so this test process keeps its own imports."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib
import pkgutil
import sys

sys.modules["jax"] = None          # "import jax" raises ImportError
sys.modules["jaxlib"] = None
sys.modules["cloudpickle"] = None


class RefuseRepro:
    """Refuse the JAX package ``repro`` (and only it: not repro_torch)."""

    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port must not import {name}")
        return None


sys.meta_path.insert(0, RefuseRepro())

import repro_torch

names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                      "repro_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: E402,F401

leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "cloudpickle")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("IMPORTED", " ".join(names))
'''


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("IMPORTED")][-1]
    imported = set(line.split()[1:])
    for name in ("repro_torch.core.discovery", "repro_torch.core.schedule",
                 "repro_torch.ptg.graph", "repro_torch.linalg.gemm",
                 "repro_torch.linalg.cholesky", "repro_torch.taskbench",
                 "repro_torch.kernels._build",
                 "repro_torch.kernels.block_gemm.block_gemm",
                 "repro_torch.kernels.block_gemm.ops",
                 "repro_torch.kernels.block_gemm.ref",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.ssd_scan.ssd_scan",
                 "repro_torch.kernels.ssd_scan.ops",
                 "repro_torch.kernels.ssd_scan.ref",
                 "repro_torch.kernels.decode_attention.decode_attention",
                 "repro_torch.kernels.decode_attention.ops",
                 "repro_torch.kernels.decode_attention.ref",
                 "repro_torch.configs.base", "repro_torch.configs.registry",
                 "repro_torch.configs.mamba2_1_3b",
                 "repro_torch.configs.yi_6b",
                 "repro_torch.launch.flags", "repro_torch.launch.serve",
                 "repro_torch.models.layers", "repro_torch.models.mamba2",
                 "repro_torch.models.attention",
                 "repro_torch.models.transformer",
                 "repro_torch.models.convert",
                 "repro_torch.serve.decode",
                 "repro_torch.core.faults", "repro_torch.core.threadpool",
                 "repro_torch.core.taskflow", "repro_torch.core.stf",
                 "repro_torch.core.messages", "repro_torch.core.completion",
                 "repro_torch.core.runtime", "repro_torch.core.comm",
                 "repro_torch.core.comm.core", "repro_torch.core.comm.inproc",
                 "repro_torch.core.comm.multiproc",
                 "repro_torch.train.elastic",
                 "repro_torch.linalg.host_exec"):
        assert name in imported, name
