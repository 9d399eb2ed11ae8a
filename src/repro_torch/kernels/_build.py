"""Build the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` and load them
with ``ctypes``.

Each source becomes a shared library with a plain C interface, compiled for
Hopper (``sm_90a``) into ``_build/`` beside this file at first use. The
library's name carries a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded. Each build writes to a
temporary file (named by process and thread) and moves it into place with
``os.replace``, so processes that build at the same time (test workers)
never load a half-written file. Within a process one lock serialises
``build`` and ``load``, so worker threads that reach a kernel together at
first use build it once. Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
_LOCK = threading.RLock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the path, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def needs_grad(*operands) -> bool:
    """Whether autograd records an op on these operands (None skipped):
    grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands)


def refuse_grad(name: str, *operands) -> None:
    """Raise when autograd would need a gradient through a kernel launch.

    The kernels have no backward: a wrapper fills a fresh tensor through a
    ctypes call, so its output would carry no gradient and no error. The
    model routes such calls to the plain versions before they get here
    (``models/attention.py``, ``kernels/ssd_scan/ops.py``), so this only
    stops a caller that would lose its gradients."""
    if needs_grad(*operands):
        raise RuntimeError(
            f"{name}: an operand requires grad, and the kernel has no "
            "backward; call its plain version, or run under torch.no_grad()")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on its source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def build(*names: str) -> Dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took
    (empty when everything was built already); raises with the compiler's
    output if any build fails."""
    with _LOCK:
        return _build(names)


def _build(names) -> Dict[str, float]:
    BUILD.mkdir(exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed (once
    per process, whichever thread asks first)."""
    with _LOCK:
        return _load(name)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build(name)
    return ctypes.CDLL(str(library_path(name)))
