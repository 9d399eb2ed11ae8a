"""Multi-rank execution context — SPMD launch over a pluggable transport.

``run_ranks(n_ranks, main, n_threads=...)`` runs ``main(ctx)`` once per rank,
SPMD-style, exactly like the paper's example program::

    Communicator comm(MPI_COMM_WORLD);
    Threadpool   tp(n_threads, &comm);
    Taskflow<int> tf(&tp);
    ... seed ... ; tp.join();

Each rank owns a main (comm) thread — which runs the user's ``main`` and
then, inside ``tp.join()``, the progress + completion-detection loop — and
``n_threads`` worker threads. Delivery delay/reorder can be injected via
``delay_fn``, and loss/duplication/rank-death via ``faults`` (a
:class:`~repro_torch.core.faults.FaultPlan`), to stress the completion protocol;
with ``faults`` set, ``run_ranks`` returns ``(results, RecoveryReport)``.

Where the ranks *live* is decided by ``transport=`` (or the
``REPRO_TRANSPORT`` env var): the default ``inproc`` backend emulates each
rank as a thread-group in this process; the ``multiproc`` backend forks one
real OS process per rank and carries the same wire messages over loopback
TCP sockets. Everything above the world contract — reliable delivery,
completion detection, DEATH/epoch recovery, the scheduler — is identical
on both. See :mod:`repro_torch.core.comm`.

Failure semantics:

- a rank killed by the fault plan simply stops (its result is ``None``;
  survivors recover via the membership protocol in ``core.completion``);
- a rank that *raises* poisons the world; the other ranks abort as victims
  and the **root cause** is re-raised with its full formatted traceback —
  not the victims' "world poisoned" echoes;
- a timeout raises with a per-rank forensic dump: which ranks are stuck and
  each stuck rank's last protocol state (counters, unacked sends, detector
  epoch/confirmations) instead of a bare TimeoutError.

The port's copy of the JAX package's ``repro.core.runtime``, equal in
behaviour.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

from .comm import get_backend
from .completion import CompletionDetector
from .faults import FaultPlan
from .messages import Communicator, RankKilled, WorldPoisoned
from .taskflow import Taskflow
from .threadpool import Threadpool


@dataclass
class RankContext:
    rank: int
    n_ranks: int
    comm: Communicator
    tp: Threadpool
    _results: dict = field(default_factory=dict)

    def taskflow(self, name: str = "tf") -> Taskflow:
        return Taskflow(self.tp, name=name)

    def barrier_free_join(self) -> None:
        """The paper's ``tp.join()`` — distributed completion, no barrier."""
        self.tp.join()


def rank_session(world, rank: int, main, n_threads: int):
    """One rank's whole life, shared by every backend: build the
    communicator / threadpool / detector stack on ``world``, run ``main``,
    classify the outcome.

    Returns ``(status, payload)`` with status one of ``"ok"`` (payload =
    main's return value), ``"killed"`` (crashed by the fault plan — its
    silence is the point, survivors recover), ``"poisoned"`` (victim of
    another rank's failure; aborts quietly so the root cause is the only
    error surfaced), or ``"error"`` (payload = the exception; the session
    has already poisoned the world).
    """
    comm = Communicator(world, rank)
    tp = Threadpool(n_threads, comm)
    CompletionDetector(comm)
    ctx = RankContext(rank, world.n_ranks, comm, tp)
    world.attach_snapshot_provider(rank, comm.snapshot)
    try:
        return "ok", main(ctx)
    except RankKilled:
        tp.abort()
        return "killed", None
    except WorldPoisoned:
        tp.abort()
        return "poisoned", None
    except BaseException as e:  # surfaced to the caller
        comm.shutdown.set()
        world.poison.set()  # unblock every other rank's join()
        tp.abort()
        return "error", e


def format_rank_error(err: BaseException) -> str:
    return "".join(traceback.format_exception(type(err), err,
                                              err.__traceback__))


def timeout_forensics(stuck, world, timeout: float) -> str:
    """Per-rank protocol state for the deadlock report: which ranks hung,
    and what their communicator/scheduler last looked like. ``stuck`` is a
    list of rank numbers; each snapshot is pulled through the world's
    snapshot providers (cross-process safe)."""
    lines = [
        f"{len(stuck)} rank thread(s) did not finish within {timeout}s "
        "(possible completion-protocol deadlock):"
    ]
    for rank in stuck:
        snap = world.snapshot_rank(rank)
        if snap is None:
            lines.append(f"  rank {rank}: stuck before context creation")
        else:
            lines.append(f"  rank {rank}: {snap}")
    return "\n".join(lines)


def run_ranks(
    n_ranks: int,
    main: Callable[[RankContext], object],
    *,
    n_threads: int = 2,
    delay_fn: Optional[Callable[[int, int, str], float]] = None,
    faults: Optional[FaultPlan] = None,
    timeout: float = 120.0,
    serve_scheduler=None,
    transport: Optional[str] = None,
):
    """SPMD-launch ``main`` on ``n_ranks`` ranks; returns per-rank results
    (or ``(results, report)`` when ``faults`` is given). Raises on
    per-rank exception or timeout (deadlock guard).

    ``transport`` selects the registered comm backend (default: the
    ``REPRO_TRANSPORT`` env var, else ``inproc``).

    ``serve_scheduler`` (a
    :class:`repro_torch.sched.SchedulerService`) switches
    to resident mode: ranks stay alive between submissions for as long as
    the service is open, so the deadlock deadline only arms once the
    service's ``draining`` event is set (``close()`` sets it before
    posting STOP) — an idle resident rank is not a hang. Everything else
    (poison propagation, timeout forensics, error surfacing) is
    unchanged."""
    backend = get_backend(transport)
    return backend.run_ranks(
        n_ranks, main, n_threads=n_threads, delay_fn=delay_fn,
        faults=faults, timeout=timeout, serve_scheduler=serve_scheduler)
