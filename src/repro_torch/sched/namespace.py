"""Named block namespaces: how submissions in a stream depend on each other.

The port's copy of the JAX package's ``repro.sched.namespace``: version
values are tensors on the service's device, and :meth:`NamespaceShard
.restore` keeps a retired version that is still a block's live one (see
there).

A one-shot run reads its inputs from an initial store and returns its
writes. In a stream, a later PTG must be able to read blocks a prior PTG
wrote — *without* any global graph tying the two together. The scheduler
expresses this with named namespaces: each submission targets a namespace,
its external reads (operand blocks with no producer inside its own graph,
``LocalView.external_reads``) bind to namespace versions, and its final
writes (``LocalView.final_writes``) publish new versions.

Versions are keyed ``(sub_id, kind)`` with kind 0 = initial-value seed and
kind 1 = final write, so the binding rule is a pure function of submission
ids: *reader submission r binds block B to the latest version with key
< (r, 1)* — its own initial seed (r, 0) included, any earlier submission's
write preferred over it. Every rank processes the submission bus in the
same total order, so all ranks resolve identical bindings with no
negotiation — the stream-level analogue of the PTG's "dependencies are a
pure function of the task id".

Lifecycle mirrors the task state machine: a version is PENDING from
assimilation (the owner rank learns a final write is coming) until the
writer publishes (AVAILABLE) or its submission fails (POISONED — readers
that bound to it fail too, instead of deadlocking). Both resolutions are
final: a straggler publish from a failed submission's surviving task
never flips POISONED back, and one whose version retirement already
dropped is discarded — what readers observe is a pure function of bus
order, never of message timing. Retirement is driven
by the frontdoor's watermark (the resolved-submission prefix): a version
superseded by a later one at or below the watermark can never be a
binding target again and is dropped — namespace memory holds the latest
resolved version per block plus in-flight ones, not the stream's history.

Ownership: a namespace's blocks are sharded by the graph owner mapping,
which must therefore be consistent across the submissions of a namespace
(the service checks nothing here — a block whose owner moves between
submissions would silently split its timeline across ranks).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List, Tuple

from .state import LiveStats

B = Hashable

PENDING, AVAILABLE, POISONED = "pending", "available", "poisoned"


class _Version:
    __slots__ = ("key", "state", "value", "waiters")

    def __init__(self, key: Tuple[int, int], state: str, value=None):
        self.key = key          # (sub_id, kind): 0 seed, 1 final write
        self.state = state
        self.value = value
        self.waiters: List[Callable] = []  # cb(value, poisoned)


class NamespaceShard:
    """One rank's slice of every namespace: per owned block, a short
    timeline of versions in key order. All methods are thread-safe;
    waiter callbacks fire outside the lock."""

    def __init__(self, stats: LiveStats) -> None:
        self._lock = threading.Lock()
        self._vers: Dict[Tuple[str, B], List[_Version]] = {}
        self._stats = stats
        # resolved-prefix watermark seen by retire_through: versions of
        # submissions <= this may already have been dropped as superseded,
        # so straggler publishes for them must not re-insert stale state
        self._retired = 0

    # -------------------------------------------------------------- writes

    def seed_initial(self, ns: str, blk: B, sub_id: int, value) -> bool:
        """Submission-provided initial value for an owned block — only
        honored on a virgin timeline: once any submission wrote (or is
        writing) the block, the namespace value is the truth and a later
        submission's initial value is ignored. A timeline holding *only*
        POISONED versions counts as virgin again: every writer so far
        failed, so a retry resubmitting the same inputs gets its seeds
        honored instead of deterministically binding to the poison (the
        FAIL command precedes the retry's SUBMIT in bus order, so the
        decision is a pure function of the bus prefix on every rank).
        Only versions *visible to this submission* (key < ``(sub_id, 0)``)
        count: a later submission's publish racing ahead of this
        assimilation — or a checkpoint restore inserting future-submission
        versions before adoption replay — must not flip the decision, or
        it would stop being a pure function of the bus prefix. (Safe
        against retirement: a dropped earlier version implies a surviving
        later version that is still < ``(sub_id, 0)``, since unresolved
        submissions sit above the watermark.)
        Returns True iff the seed was inserted (the owner reports honored
        seeds to the frontdoor checkpoint for adoption replay)."""
        with self._lock:
            timeline = self._vers.setdefault((ns, blk), [])
            if any(v.key == (sub_id, 0) for v in timeline):
                return True   # adoption replay re-seeding: already honored
            if any(v.state != POISONED for v in timeline
                   if v.key < (sub_id, 0)):
                return False
            self._insert(timeline, _Version((sub_id, 0), AVAILABLE, value))
        self._stats.block_up()
        return True

    def ensure_pending(self, ns: str, blk: B, sub_id: int) -> None:
        """Owner-side assimilation of a final write: reserve the version so
        readers of later submissions can bind (and wait) before the writer
        has run. No-op if publish already raced ahead."""
        with self._lock:
            timeline = self._vers.setdefault((ns, blk), [])
            if any(v.key == (sub_id, 1) for v in timeline):
                return
            self._insert(timeline, _Version((sub_id, 1), PENDING))

    def publish(self, ns: str, blk: B, sub_id: int, value) -> None:
        """Fill (or create) version ``(sub_id, 1)`` and serve its waiters.
        May arrive before the owner assimilated ``sub_id`` — the writer's
        rank runs ahead — in which case the publish creates the version;
        no reader of a later submission can have bound yet, because the
        owner binds readers only after assimilating them, in bus order.

        Two straggler cases are ignored so resolution stays final and
        timing-independent: a POISONED version stays poisoned (a task of a
        failed submission finishing on another rank after the fail command
        must not resurrect the value), and a publish whose version
        ``retire_through`` already dropped as superseded must not
        re-insert it (it could never be a binding target again)."""
        with self._lock:
            timeline = self._vers.setdefault((ns, blk), [])
            for v in timeline:
                if v.key == (sub_id, 1):
                    break
            else:
                if sub_id <= self._retired:
                    if not timeline:
                        del self._vers[(ns, blk)]
                    return
                v = _Version((sub_id, 1), PENDING)
                self._insert(timeline, v)
            if v.state == POISONED:
                return
            first = v.state != AVAILABLE
            v.state = AVAILABLE
            v.value = value
            waiters, v.waiters = v.waiters, []
        if first:
            self._stats.block_up()
        for cb in waiters:
            cb(value, False)

    def restore(self, ns: str, blk: B, key: Tuple[int, int], state: str,
                value=None) -> None:
        """Insert an already-*resolved* version (AVAILABLE or POISONED)
        verbatim — the frontdoor checkpoint recording a resolved
        submission's effect, and an adopter reseeding its shard from that
        checkpoint after a rank death. Idempotent; never downgrades: an
        existing POISONED version stays poisoned, an existing AVAILABLE one
        keeps its value, and a PENDING one is resolved in place (serving
        its waiters). An AVAILABLE restore for a retired submission is
        discarded only when the timeline already holds a later version
        within the retired prefix (it is superseded, like a straggler
        publish); otherwise it is the block's live binding target and is
        inserted. (The JAX package discards every such restore, which
        loses the adopted shard's blocks when a rank dies after the
        watermark has passed their last writer: the adopter's timelines
        for a shard it never hosted are empty.) POISONED restores bypass
        the guard — a poison that is the *latest* version of a retired
        timeline is still the live binding target, and a superseded one is
        inert residue the next ``retire_through`` drops."""
        fresh = False
        with self._lock:
            timeline = self._vers.setdefault((ns, blk), [])
            for v in timeline:
                if v.key == key:
                    break
            else:
                if state == AVAILABLE and key[0] <= self._retired and any(
                        key < u.key <= (self._retired, 1) for u in timeline):
                    if not timeline:
                        del self._vers[(ns, blk)]
                    return
                v = _Version(key, PENDING)
                self._insert(timeline, v)
            if v.state != PENDING:
                return
            fresh = state == AVAILABLE
            v.state = state
            v.value = value
            waiters, v.waiters = v.waiters, []
        if fresh:
            self._stats.block_up()
        for cb in waiters:
            cb(value, state == POISONED)

    def export(self) -> List[tuple]:
        """Every resolved version, as ``(ns, blk, key, state, value)`` rows
        feedable to :meth:`restore`. PENDING versions are excluded: they
        belong to in-flight submissions, which adoption reconstructs by
        replaying the bus, not by copying state."""
        with self._lock:
            return [(ns, blk, v.key, v.state, v.value)
                    for (ns, blk), timeline in self._vers.items()
                    for v in timeline if v.state != PENDING]

    @staticmethod
    def _insert(timeline: List[_Version], v: _Version) -> None:
        i = len(timeline)
        while i > 0 and timeline[i - 1].key > v.key:
            i -= 1
        timeline.insert(i, v)

    # --------------------------------------------------------------- reads

    def bind(self, ns: str, blk: B, reader_sub: int, cb: Callable) -> None:
        """Bind one external read of ``reader_sub`` to its version (latest
        key < ``(reader_sub, 1)``). Requires every submission up to
        ``reader_sub`` assimilated on this rank — the callers guarantee it
        (local binds run during assimilation; remote fetches are held until
        the owner catches up). ``cb(value, poisoned)`` fires immediately if
        the version is resolved, else when it resolves."""
        with self._lock:
            timeline = self._vers.get((ns, blk), [])
            target = None
            for v in timeline:
                if v.key < (reader_sub, 1):
                    target = v
                else:
                    break
            if target is None:
                raise KeyError(
                    f"namespace {ns!r}: block {blk!r} has no version visible "
                    f"to submission {reader_sub} (not written by any earlier "
                    "submission and no initial value supplied)")
            if target.state == PENDING:
                target.waiters.append(cb)
                return
            value, poisoned = target.value, target.state == POISONED
        cb(value, poisoned)

    # ---------------------------------------------------------- lifecycle

    def poison_sub(self, sub_id: int) -> List[Tuple[str, B]]:
        """A submission failed: its unproduced (still PENDING) versions
        will never publish — poison them so readers fail loudly instead of
        waiting forever. Versions it already published keep their value.
        Returns the ``(ns, blk)`` keys poisoned, so the owner rank can
        report them to the frontdoor checkpoint (a poison can be the live
        binding target of a timeline; an adopter reconstructing the
        namespace without it would silently bind readers to stale earlier
        data instead of failing them)."""
        fire: List[Callable] = []
        keys: List[Tuple[str, B]] = []
        with self._lock:
            for (ns, blk), timeline in self._vers.items():
                for v in timeline:
                    if v.key == (sub_id, 1) and v.state == PENDING:
                        v.state = POISONED
                        keys.append((ns, blk))
                        fire.extend(v.waiters)
                        v.waiters = []
        for cb in fire:
            cb(None, True)
        return keys

    def retire_through(self, watermark: int) -> None:
        """Drop versions superseded within the resolved prefix: any version
        strictly before the last one with key <= ``(watermark, 1)`` cannot
        bind a future reader (all readers <= watermark are resolved; any
        later reader binds at or after that survivor). Waiters only exist
        on PENDING versions of unresolved submissions, which survive."""
        freed = 0
        with self._lock:
            self._retired = max(self._retired, watermark)
            for key, timeline in list(self._vers.items()):
                cut = 0
                for i, v in enumerate(timeline):
                    if v.key <= (watermark, 1):
                        cut = i
                if cut:
                    freed += sum(1 for v in timeline[:cut]
                                 if v.state == AVAILABLE)
                    del timeline[:cut]
        if freed:
            self._stats.block_down(freed)

    def drop_namespace(self, ns: str) -> None:
        """Drop every timeline of an *ephemeral* namespace (one no later
        submission will ever target — ``Client.map``'s throwaway
        namespaces). The frontdoor posts the drop after the watermark has
        passed the namespace's one submission, so any straggler publish
        that follows is caught by the ``_retired`` guard instead of
        resurrecting state. Surviving waiters (there should be none on a
        resolved submission) fail loudly rather than hang."""
        freed = 0
        fire: List[Callable] = []
        with self._lock:
            for key in [k for k in self._vers if k[0] == ns]:
                for v in self._vers.pop(key):
                    if v.state == AVAILABLE:
                        freed += 1
                    fire.extend(v.waiters)
                    v.waiters = []
        if freed:
            self._stats.block_down(freed)
        for cb in fire:
            cb(None, True)

    def live_versions(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._vers.values())
