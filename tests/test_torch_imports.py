"""The port stands alone: every ``repro_torch`` module, ``chip_smoke.py``
and the port's examples (``examples/torch_*.py``) import with JAX
blocked, the JAX package ``repro`` refused, and ``cloudpickle`` and
``ml_dtypes`` blocked (the GPU machine has neither; only a
cross-process run of the ``multiproc`` transport needs cloudpickle, and
checkpoints move bfloat16 through torch's own views), in a subprocess, so
this test process keeps its own imports; a spawned rank process
(``repro_torch.dist.ranks``) that has run a ranked program imports none
of JAX or ``repro`` either; and ``torch_quickstart.py`` runs end to end
on the CPU."""

import glob
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
sys.modules["ml_dtypes"] = None


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
import glob  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402

examples = []
for path in sorted(glob.glob("examples/torch_*.py")):
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    examples.append(name)
print("EXAMPLES", " ".join(examples))

leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "cloudpickle",
                                       "ml_dtypes")
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
                 "repro_torch.models.moe", "repro_torch.models.convert",
                 "repro_torch.serve.decode",
                 "repro_torch.core.faults", "repro_torch.core.threadpool",
                 "repro_torch.core.taskflow", "repro_torch.core.stf",
                 "repro_torch.core.messages", "repro_torch.core.completion",
                 "repro_torch.core.runtime", "repro_torch.core.comm",
                 "repro_torch.core.comm.core", "repro_torch.core.comm.inproc",
                 "repro_torch.core.comm.multiproc",
                 "repro_torch.train.elastic",
                 "repro_torch.linalg.host_exec",
                 "repro_torch.sched", "repro_torch.sched.fair",
                 "repro_torch.sched.namespace", "repro_torch.sched.proxy",
                 "repro_torch.sched.service", "repro_torch.sched.state",
                 "repro_torch.launch.scheduler",
                 "repro_torch.launch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.train_step",
                 "repro_torch.train.checkpoint", "repro_torch.train.data",
                 "repro_torch.train.tree", "repro_torch.dist",
                 "repro_torch.dist.ctx", "repro_torch.dist.sharding",
                 "repro_torch.dist.pipeline", "repro_torch.launch.mesh",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.dist.ranks", "repro_torch.attention_chain"):
        assert name in imported, name
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("EXAMPLES")][-1]
    assert line.split()[1:] == ["torch_distributed_cholesky",
                                "torch_quickstart", "torch_serve_lm",
                                "torch_train_lm"]


def test_torch_quickstart_runs_on_the_cpu():
    """``examples/torch_quickstart.py --device cpu`` end to end: the chain
    on the host runtime, and one Cholesky on both backends."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_quickstart.py"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "final value 12" in proc.stdout
    assert "[one graph, two backends]" in proc.stdout
    assert len(glob.glob(os.path.join(REPO, "examples", "torch_*.py"))) == 4


def test_spawned_rank_imports_no_jax_or_repro():
    """Two rank processes run the attention chain on the CPU (each its own
    shard, gloo between them), then report what they imported."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.attention_chain import chain_rank
    from repro_torch.dist.ranks import rank_probe, run_jobs, spawn_ranks

    runs = [{"name": "auto", "auto": True}]
    per_rank = spawn_ranks(run_jobs, 2, [(chain_rank, (3, 8, 4, runs), {}),
                                         (rank_probe, (), {})],
                           device="cpu", timeout=300)
    for chain, modules in per_rank:
        assert chain[0]["calls"]["attn"] == 3
        assert "torch" in modules
        assert not {"jax", "jaxlib", "repro"} & set(modules), modules
