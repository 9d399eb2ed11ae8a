"""Faults planted under the timed path, and the control put in the
program's place: each must make a run's check come out not correct.

The tests drive whole runs with each (``tests/test_portbench_faults.py``),
and ``control.py`` reads the control's numbers at a cell's own size on the
card. A plant takes the run's executor and returns what the window calls
in its place; nothing here runs in a benchmark run.
"""

from __future__ import annotations

import torch

from portbench.loop import on

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def plant(name: str, *, ex, body, prog, cfg, app, ref, inputs, stores,
          rank):
    if name == "control":
        return _control(prog, cfg, app, ref, inputs, stores, rank)
    if name == "unchanged":
        # a step that hands back its state as it found it
        return lambda store: store.clone()
    if name == "half_batch":
        # the GEMM-type bodies compute only the first half of each batch;
        # the other half's update is left out
        mm = body.mm

        def half(a, b):
            out = mm(a, b)
            out[(a.shape[0] + 1) // 2:] = 0
            return out

        body.mm = half
        return ex
    if name == "no_exchange":
        # blocks exchanged never land in the store (a rank still takes
        # them out of its mailbox, so that its peers are not held up)
        def land(local, pending):
            for p in pending:
                if hasattr(p, "wait"):
                    p.wait()

        ex.land = land
        return ex
    if name == "altered":
        # one element of the first GEMM-type result of each step is changed
        # where it is produced
        mm = body.mm
        first = [True]

        def alter(a, b):
            out = mm(a, b)
            if first[0]:
                out.view(-1)[0] += 1e-2
                first[0] = False
            return out

        body.mm = alter

        def run(store):
            first[0] = True
            return ex(store)

        return run
    raise ValueError(f"no fault named {name!r}")


def _control(prog, cfg, app, ref, inputs, stores, rank):
    """The plain reference computed in TF32, written where the program
    writes its result blocks."""
    b0, b1 = prog.spec.block_shape
    held = [(prog.slot_of[blk], rc) for blk, rc in app.result_blocks(cfg)
            if rank is None or prog.slot_of[blk][0] == rank]

    def run(store):
        which = next(i for i, s in enumerate(stores) if s is store)
        got = app.reference(cfg, on(inputs[which], store.device), ref,
                            dtype=torch.float32, tf32=True)
        out = store.clone()
        for (s, slot), (r, c) in held:
            out[0 if rank is not None else s, slot] = \
                got[r * b0:(r + 1) * b0, c * b1:(c + 1) * b1]
        return out

    return run
