"""How long the host stalls under ``chip_smoke.py``: rank 0's longest gaps
between inbox reads under a FaultPlan, and the garbage collector's pauses.

    python scripts/torch_pause_probe.py

Runs ``chip_smoke.main()`` (on one CUDA GPU, every phase and gate) with
two probes around it:

- every ``CompletionDetector.on_poll`` of a rank 0 that runs leases (a
  service or host runtime under a ``FaultPlan``) records the time since
  its previous inbox read;
- ``gc.callbacks`` records each collection's pause and generation.

After ``chip_smoke.py``'s own output it prints the gaps over 0.1 s and the
ten longest pauses, then exits with ``chip_smoke.py``'s code. A gap or
pause longer than a lease (0.4 s in ``phase_scheduler``'s kill stream) is
a stall no rank's heartbeats could cross.
"""

import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.core import completion  # noqa: E402

gaps, pauses, started = [], [], {}
real_on_poll = completion.CompletionDetector.on_poll


def on_poll(self):
    if self._monitor is not None and self._polled_at is not None:
        gaps.append(time.monotonic() - self._polled_at)
    return real_on_poll(self)


def on_gc(phase, info):
    if phase == "start":
        started["t"] = time.perf_counter()
    else:
        pauses.append((time.perf_counter() - started["t"],
                       info["generation"]))


def main() -> int:
    completion.CompletionDetector.on_poll = on_poll
    gc.callbacks.append(on_gc)
    import chip_smoke

    rc = chip_smoke.main()
    gaps.sort(reverse=True)
    pauses.sort(reverse=True)
    print(f"probe: rank-0 inbox gaps over 0.1 s "
          f"{[round(g, 3) for g in gaps if g > 0.1][:20]} of {len(gaps)} "
          f"reads")
    print(f"probe: longest gc pauses (s, generation) "
          f"{[(round(p, 3), g) for p, g in pauses[:10]]} of {len(pauses)}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
