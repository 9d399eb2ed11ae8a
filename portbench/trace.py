"""Reads a process's ``torch.profiler`` trace of the window into a small
record, and the records of every process of a cell into the device's busy
time, its idle gaps and the time of the program's GEMM-type bodies.

Timestamps are the profiler's, nanoseconds of the host's wall clock, so
the records of rank processes on one host line up.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from portbench.yardstick import gaps, union_s

# the ranges the harness opens: around each call of the bodies' matmul,
# and around the whole window
BODY = "portbench.body"
WINDOW = "portbench.window"
# what runs on the device, as the profiler names its activities
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LABELLED_GAPS = 1000
TOP = 10


def _event(e) -> tuple:
    """(kind, name, start ns, end ns) of a profiler event, where ``kind``
    is read from the event's device and its name."""
    name = e.name()
    start = e.start_ns()
    note = (name.startswith("portbench.")
            or getattr(e, "is_user_annotation", lambda: False)())
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        kind = "gpu_user_annotation" if note else "kernel"
    elif note:
        kind = "user_annotation"
    elif name.startswith("cuda") or (name.startswith("cu")
                                     and name[2:3].isupper()):
        kind = "cuda_runtime"
    else:
        kind = "cpu_op"
    return kind, name, start, start + e.duration_ns()


def summarize(prof, lo_ns: int, hi_ns: int) -> dict:
    """One process's trace over the window: the harness's ``WINDOW``
    range, else ``[lo_ns, hi_ns)`` on the host's clock.

    ``body`` holds the device intervals of the operations launched inside
    the harness's ``BODY`` ranges: found by their launch on the host (a
    launch call that starts inside a body range of its thread) through the
    profiler's correlation id, or by the range itself where the profiler
    links them."""
    dev, dev_corr, dev_link, dev_name = [], [], [], []
    host, host_name = [], []
    body_iv: Dict[int, list] = defaultdict(list)
    body_ids = set()
    launches = []
    seen = 0
    events = [(_event(e), e) for e in prof.profiler.kineto_results.events()]
    for (kind, name, start, end), _ in events:
        if kind == "user_annotation" and name == WINDOW:
            lo_ns, hi_ns = start, end
    for (kind, name, start, end), e in events:
        seen += kind in DEVICE_KINDS
        if end <= lo_ns or start >= hi_ns:
            continue
        if kind in DEVICE_KINDS:
            dev.append((max(start, lo_ns), min(end, hi_ns)))
            dev_corr.append(e.correlation_id())
            dev_link.append(e.linked_correlation_id())
            dev_name.append(e.name())
            continue
        if kind not in HOST_KINDS or name == WINDOW:
            continue
        host.append((start, end))
        host_name.append(name)
        if kind == "user_annotation" and name == BODY:
            body_iv[e.start_thread_id()].append((start, end))
            body_ids.add(e.correlation_id())
        elif kind in ("cuda_runtime", "cuda_driver") and "aunch" in name:
            launches.append((start, e.start_thread_id(), e.correlation_id()))
    body_corr = set()
    for tid, ranges in body_iv.items():
        iv = np.asarray(sorted(ranges), dtype=np.int64)
        for start, t, corr in launches:
            if t != tid:
                continue
            i = int(np.searchsorted(iv[:, 0], start, side="right")) - 1
            if i >= 0 and start < iv[i, 1]:
                body_corr.add(corr)
    dev_arr = np.asarray(dev, dtype=np.int64).reshape(-1, 2)
    in_body = np.array([c in body_corr or l in body_ids
                        for c, l in zip(dev_corr, dev_link)], dtype=bool)
    dur = dev_arr[:, 1] - dev_arr[:, 0]
    ops: Dict[str, int] = defaultdict(int)
    for name, d in zip(dev_name, dur.tolist()):
        ops[name] += d
    names = sorted(set(host_name))
    index = {n: i for i, n in enumerate(names)}
    return {"lo": lo_ns, "hi": hi_ns, "dev": dev_arr, "seen": seen,
            "body": dev_arr[in_body],
            "body_ops": int(in_body.sum()), "body_ranges": len(body_ids),
            "ops": dict(ops),
            "host": np.asarray(host, dtype=np.int64).reshape(-1, 2),
            "host_name": np.asarray([index[n] for n in host_name],
                                    dtype=np.int64),
            "host_names": names}


def combine(records: List[dict]) -> dict:
    """The cell's device over the window from every process's record:
    ``busy_s`` (the union of what ran on the card), ``window_s``,
    ``body_s`` (the union of the bodies' device intervals: processes on one
    card take turns on it, and each kernel's interval holds the others'
    turns, so a sum over processes would count those again) and the
    breakdown: the device
    operations that took most time, and the idle gaps by the innermost
    host operation that was running at their middle, on any process."""
    lo = min(r["lo"] for r in records)
    hi = max(r["hi"] for r in records)
    dev = np.concatenate([r["dev"] for r in records])
    ops: Dict[str, int] = defaultdict(int)
    for r in records:
        for name, ns in r["ops"].items():
            ops[name] += ns
    host = np.concatenate([r["host"] for r in records])
    labels = np.concatenate([
        np.asarray(r["host_names"], dtype=object)[r["host_name"]]
        if len(r["host_name"]) else np.empty(0, dtype=object)
        for r in records])
    idle = _label_gaps(gaps(dev, lo, hi), host, labels)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": union_s(dev), "window_s": (hi - lo) / 1e9,
            "body_s": union_s(np.concatenate([r["body"] for r in records])),
            "body_ops": sum(r["body_ops"] for r in records),
            "body_ranges": sum(r["body_ranges"] for r in records),
            "seen": sum(r["seen"] for r in records), "kept": len(dev),
            "breakdown": {
                "device_ops": [[n[:200], ns / 1e9] for n, ns in top_ops],
                "idle_gaps": idle}}


def _label_gaps(g: np.ndarray, host: np.ndarray, labels) -> list:
    """Seconds of idle gap by label, most first: the longest
    ``LABELLED_GAPS`` gaps each by the innermost host operation covering
    its middle, the rest together."""
    by: Dict[str, int] = defaultdict(int)
    order = np.argsort(host[:, 0], kind="stable") if len(host) else []
    starts = host[order, 0] if len(host) else host[:, 0]
    ends = host[order, 1] if len(host) else host[:, 1]
    names = labels[order] if len(host) else labels
    for lo, hi in g[:LABELLED_GAPS]:
        mid = (lo + hi) // 2
        label = "no host operation"
        n = int(np.searchsorted(starts, mid, side="right"))
        for first in (max(0, n - 4096), 0):
            cover = np.flatnonzero(ends[first:n] >= mid)
            if len(cover):
                span = ends[first:n][cover] - starts[first:n][cover]
                label = str(names[first + cover[np.argmin(span)]])
                break
        by[label[:200]] += int(hi - lo)
    rest = int((g[LABELLED_GAPS:, 1] - g[LABELLED_GAPS:, 0]).sum())
    if rest:
        by[f"shorter gaps than the {LABELLED_GAPS} longest"] += rest
    return [[n, ns / 1e9] for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
