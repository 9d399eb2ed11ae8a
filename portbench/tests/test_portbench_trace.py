"""The reduction of profiler traces to busy time, idle gaps and the
bodies' device time, on made-up events."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import trace
from portbench.yardstick import gaps, to_tf32, union_s


def test_union_and_gaps():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 60]],
                  dtype=np.int64)
    assert union_s(iv) == pytest.approx(40e-9)
    g = gaps(iv, -5, 70)
    assert g.tolist() == [[20, 30], [40, 50], [60, 70], [-5, 0]]
    assert union_s(np.zeros((0, 2), dtype=np.int64)) == 0.0


class Event:
    """A profiler event, with the calls of PyTorch's that the reader
    uses."""

    def __init__(self, name, start, dur, cuda=False, corr=0, link=0, tid=1):
        self._v = (name, start, dur, cuda, corr, link, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()


def test_summary_finds_the_window_the_bodies_and_the_gaps():
    events = [
        Event(trace.WINDOW, 100, 900),
        Event(trace.BODY, 200, 50, corr=7),
        Event("cudaLaunchKernel", 210, 5, corr=11),
        Event("aten::add", 300, 40, corr=8),
        Event("cudaLaunchKernel", 310, 5, corr=12),
        Event("cudaStreamSynchronize", 600, 300, corr=13),
        Event("sgemm_ring", 220, 100, cuda=True, corr=11, link=7),
        Event("add_kernel", 330, 30, cuda=True, corr=12, link=8),
        Event("add_kernel", 2000, 30, cuda=True, corr=14, link=9),
        Event(trace.BODY, 220, 100, cuda=True),     # a device-side range
    ]
    rec = trace.summarize(Prof(events), 0, 10 ** 6)
    assert (rec["lo"], rec["hi"]) == (100, 1000)
    assert rec["body"].tolist() == [[220, 320]] and rec["body_ops"] == 1
    assert rec["seen"] == 3 and len(rec["dev"]) == 2
    world = trace.combine([rec, rec])
    assert world["busy_s"] == pytest.approx(130e-9)
    assert world["window_s"] == pytest.approx(900e-9)
    # two processes' bodies over the same interval: the card ran them in
    # turns within it, so it counts once
    assert world["body_s"] == pytest.approx(100e-9)
    ops = dict(world["breakdown"]["device_ops"])
    assert ops["sgemm_ring"] == pytest.approx(200e-9)
    idle = dict(world["breakdown"]["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == pytest.approx(640e-9)
    assert sum(idle.values()) == pytest.approx(770e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0000002], dtype=torch.float32)
    got = to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]
    with pytest.raises(TypeError):
        to_tf32(x.double())
