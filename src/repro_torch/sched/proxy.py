"""Cross-process facade of the scheduler frontdoor for resident ranks.

The port's copy of the JAX package's ``repro.sched.proxy``.

On the ``inproc`` transport a
:class:`~repro_torch.sched.service.ShardRuntime` calls its
:class:`~repro_torch.sched.service.SchedulerService` directly — same
address space. On ``multiproc`` the service (and its bus) live in the
parent process; each rank process gets these proxies instead, which relay
the exact method surface the rank side uses over the child's RPC channel
(``world.svc_rpc``, a lock-serialized request/response socket — see
:class:`repro_torch.core.comm.multiproc._RpcClient`).

The surface is deliberately explicit — no ``__getattr__`` magic — so a new
service dependency on the rank side fails loudly here instead of silently
pickling half a service across.
"""

from __future__ import annotations

import time
from typing import List, Optional


class BusProxy:
    """The rank-side slice of :class:`~repro_torch.sched.service._Bus`.

    ``read_from`` is the serve loop's hot poll (every ~10µs in-proc);
    over RPC an empty read is rate-limited to ~2ms so an idle resident
    rank doesn't thrash the service process.
    """

    def __init__(self, rpc):
        self._rpc = rpc
        self._last_empty = 0.0

    def read_from(self, cursor: int, reader: int) -> List[tuple]:
        now = time.monotonic()
        if now - self._last_empty < 0.002:
            return []
        out = self._rpc.call("bus", "read_from", cursor, reader)
        if not out:
            self._last_empty = now
        return out

    def read_range(self, lo: int, hi: int) -> List[tuple]:
        return self._rpc.call("bus", "read_range", lo, hi)

    def frozen_cursor(self, reader: int) -> int:
        return self._rpc.call("bus", "frozen_cursor", reader)

    def floor(self) -> Optional[int]:
        return self._rpc.call("bus", "floor")

    def retire_reader(self, reader: int, votes_needed: int = 1) -> None:
        self._rpc.call("bus", "retire_reader", reader,
                       votes_needed=votes_needed)


class ServiceProxy:
    """The rank-side slice of
    :class:`~repro_torch.sched.service.SchedulerService`.

    ``rank_stats`` / ``_runtimes`` are local placeholders: the in-proc
    service reads them for live stats and shared-memory forensics, but a
    cross-process parent gets stats from rank summaries and forensics
    over the SNAPSHOT control message instead, so the child-side writes
    just land here.
    """

    def __init__(self, rpc, n_shards: int, device):
        self._rpc = rpc
        self.n_shards = n_shards
        self.device = device    # the service's (the CPU: multiproc only)
        self.bus = BusProxy(rpc)
        self.rank_stats: list = [None] * n_shards
        self._runtimes: list = [None] * n_shards
        self._weights: dict = {}

    def client_weight(self, name: str) -> float:
        # weights are fixed at client creation: cache per name so the
        # assimilation path doesn't pay an RPC per submission
        if name not in self._weights:
            self._weights[name] = self._rpc.call("svc", "client_weight",
                                                 name)
        return self._weights[name]

    def _beat(self, rank: int) -> None:
        self._rpc.call("svc", "_beat", rank)

    def _rank_done(self, sub_id: int, shard: int, published: dict,
                   n_bytes: int, seeded=None, *, rank: int) -> None:
        self._rpc.call("svc", "_rank_done", sub_id, shard, published,
                       n_bytes, seeded=seeded, rank=rank)

    def _fail_submission(self, sub_id: int, exc: BaseException) -> None:
        self._rpc.call("svc", "_fail_submission", sub_id, exc)

    def _note_poisoned(self, sub_id: int, keys) -> None:
        self._rpc.call("svc", "_note_poisoned", sub_id, keys)

    def _published_so_far(self, sub_id: int) -> dict:
        return self._rpc.call("svc", "_published_so_far", sub_id)

    def _sub_state(self, sub_id: int) -> str:
        return self._rpc.call("svc", "_sub_state", sub_id)

    def _checkpoint_rows(self) -> list:
        return self._rpc.call("svc", "_checkpoint_rows")

    def _owner_of(self, ns: str):
        return self._rpc.call("svc", "_owner_of", ns)

    def _on_ranks_dead(self, newly, lost_shards) -> None:
        self._rpc.call("svc", "_on_ranks_dead", newly, lost_shards)
