"""One process per shard: start a world of rank processes, move blocks
between them, and run a block program on each rank.

The JAX package's block executor is SPMD over a mesh of one device per
shard (``repro.core.schedule``: ``shard_map``, ``all_to_all``,
``ppermute``), and its model path exchanges by device collectives under
``jit``. Here each shard is a process, joined to its peers in a
``torch.distributed`` group, and its exchanges go through one of two
transports, picked for the whole world when it starts (``spawn_ranks(...,
transport=)``):

- ``"device"``, the default on ``cuda``: the ranks share one card, and an
  exchange is a copy in device memory ordered by IPC events, as the JAX
  package's stays on the devices. Each rank holds a :class:`Mailbox`, a
  fixed buffer of device memory (``MAILBOX_BYTES``) that its peers map
  once, when the world starts; a rank publishes a tensor into its own
  mailbox and its readers copy (or sum) it out. Nothing is staged through
  the host and no stream is synchronised on the host. On the CPU the same
  protocol runs over shared files in the world's directory (tests).
  :class:`DeviceTransport` carries the block executor's exchanges and
  :class:`DeviceTensorTransport` the model path's.
- ``"gloo"``, the default on the CPU: gloo over host memory, with tensors
  on the card staged through pinned host buffers explicitly (gloo moves
  host memory only; the staging is :class:`_Staged`'s).
  :class:`HostTransport` carries the block executor's exchanges and
  :class:`TensorTransport` the model path's. NCCL refuses two ranks on
  one device, so on one card there is no third choice.

Either pair keeps one interface, which :func:`block_transport` and
:func:`tensor_transport` hand to the callers (``RankExecutor``,
``launch.mesh.Mesh(..., group=)``):

- the executor's: ``all_to_all`` (a dense exchange) and ``permute`` (a
  sparse round), issued at once and landed by ``wait()``, so that under
  ``overlap`` the next wavefront's halo-independent compute is enqueued
  while the blocks travel; bytes and messages per peer, exchange ms;
- the model path's: point-to-point sends and receives of tensors of any
  shape and dtype, matched by tag (the pipeline's activations and their
  gradients), f32 all-reduces over a sub-group (gradients, mask counts,
  tensor-parallel partial products), all-gathers (vocab-sharded logits,
  heartbeats) and broadcasts; bytes and messages per peer by kind.

The rest of a ranked run:

- :func:`spawn_ranks` starts ``world`` processes, joins them into a
  process group that meets through a file, runs one function on each and
  returns what each returned. They are forked from a fork server (never
  from the parent, which has usually initialised CUDA), a clean process
  that has imported torch and the port's rank modules once: a world
  starts in a fraction of a second instead of each process importing
  torch anew. Each takes the parent's environment and standard output
  and error at the call, as a spawned process would, and its call
  through a pipe (tensors in the arguments shared as a spawned process
  shares them: CPU memory by file descriptor, CUDA memory by IPC). A
  rank that raises or dies (``RankDied`` names the ranks a signal
  killed), or a world that misses its deadline, fails the call at once,
  and every child is stopped first.
- :func:`run_program` is the rank side of a run: the rank packs its own
  shard, runs the program's executor on it (``BlockProgram.executor`` /
  ``auto_executor`` with ``group=``) and returns its row, counters and
  times. Each app has an entry that builds its program and blocks from a
  seed and calls it (``linalg.cholesky.cholesky_rank``,
  ``linalg.gemm.gemm_rank``, ``taskbench.taskbench_rank``,
  ``attention_chain.chain_rank``).

A function a rank runs must be importable by name (a spawned child imports
it afresh): a module-level function of ``repro_torch``, called as
``fn(rank, world, *args, device=device, **kwargs)``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing import connection as mp_connection
from multiprocessing import reduction
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# the transports a world can take (``spawn_ranks(transport=)``), and a
# device mailbox's size: the bytes a rank can have published that its
# readers have not read yet (a larger tensor goes in pieces)
TRANSPORTS = ("device", "gloo")
MAILBOX_BYTES = 256 << 20

# this rank process's mailbox, in a world on the device transport (set and
# cleared by ``_child``: one world a process)
_MAILBOX: Optional["Mailbox"] = None


class RankDied(RuntimeError):
    """A world failed because a signal killed rank processes ``ranks``:
    told apart by their exit code from the ranks that raised (or exited)
    after them, waiting on a dead peer. A ``RuntimeError``, as any failed
    world."""

    def __init__(self, message: str, ranks: List[int]):
        super().__init__(message)
        self.ranks = ranks


def spawn_ranks(fn, world: int, *args, backend: str = "gloo",
                device="cuda", timeout: float = 600.0,
                transport: Optional[str] = None,
                mailbox_bytes: int = MAILBOX_BYTES,
                **kwargs) -> List[object]:
    """Run ``fn(rank, world, *args, device=device, **kwargs)`` in ``world``
    new processes joined into one ``torch.distributed`` group; return the
    ranks' results in rank order.

    The group meets through a file in a temporary directory (no port to
    collide with other worlds) and its collectives time out after
    ``timeout`` seconds; the whole call, start-up included, has the same
    deadline. Each child runs IEEE f32 matmuls (TF32 off) and, on the CPU,
    one thread. On ``cuda`` every kernel (and the mailbox binding) is
    built here, once, before the children load it; without a GPU the call
    raises before it spawns.

    ``transport`` is the world's: ``"device"`` (the default on ``cuda``)
    gives each rank a :class:`Mailbox` of ``mailbox_bytes`` that its peers
    map when the world starts, and the executor and meshes of the world
    exchange through it; ``"gloo"`` (the default on the CPU) stages
    through host memory. A mailbox that cannot be made or mapped fails the
    world: nothing falls back to gloo.

    Raises ``RuntimeError`` with the children's tracebacks as soon as a
    rank raises, exits or dies (:class:`RankDied`, naming the ranks that
    a signal killed, where some did), ``TimeoutError`` if the world
    misses the deadline; either way every child is killed before it
    returns."""
    dev = torch.device(device)
    transport = transport or ("device" if dev.type == "cuda" else "gloo")
    if transport not in TRANSPORTS:
        raise ValueError(f"spawn_ranks: transport {transport!r}, not one of "
                         f"{TRANSPORTS}")
    if transport == "device":
        Mailbox.check_size(mailbox_bytes)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn_ranks: device is cuda but "
                               "torch.cuda.is_available() is False")
        from repro_torch.kernels import _build

        _build.build(*sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(_PRELOAD)
        pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
        procs = mp.start_processes(
            _child, args=(world, [r for r, _ in pipes], tmp, backend,
                          str(dev), timeout, _Inherited(1), _Inherited(2),
                          transport, mailbox_bytes),
            nprocs=world, join=False, start_method="forkserver").processes
        deadline = time.monotonic() + timeout
        try:
            for r, _ in pipes:
                r.close()
            # the call goes to the ranks through the pipes, not with the
            # processes: a fork server takes a process at most ~250 file
            # descriptors, and each CPU tensor in ``args`` lends one
            # (pickled once a rank: a lent descriptor is taken once)
            job = (fn, args, kwargs, dict(os.environ))
            threading.Thread(target=_send, daemon=True, args=(
                [(w, reduction.ForkingPickler.dumps(job)) for _, w in pipes],
            )).start()
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None,
                                                                      0)]
                if failed:
                    # a signal ended a rank that died (a negative code);
                    # one that raised or exited left its traceback
                    died = [r for r in failed if codes[r] < 0]
                    message = (f"spawn_ranks: {fn.__name__} failed on "
                               f"{world} ranks\n"
                               f"{_failures(tmp, procs, died)}")
                    if died:
                        raise RankDied(message, died)
                    raise RuntimeError(message)
                if None not in codes:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn_ranks: {world} ranks of {fn.__name__} did "
                        f"not finish within {timeout} s")
                mp_connection.wait([p.sentinel for p in procs
                                    if p.exitcode is None],
                                   timeout=min(1.0, left))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _failures(tmp: str, procs, died: List[int]) -> str:
    """Every rank's traceback, the first to fail first (a rank that raises
    makes its peers fail too, waiting on it), after the ranks that died."""
    out = [f"rank {r}: killed by signal {-procs[r].exitcode}"
           for r in died]
    files = sorted((f for f in os.listdir(tmp) if f.endswith(".err")),
                   key=lambda f: os.path.getmtime(os.path.join(tmp, f)))
    for f in files:
        with open(os.path.join(tmp, f)) as fh:
            out.append(f"rank {f[4:-4]}:\n{fh.read()}")
    return "\n".join(out)


# what the fork server imports once for every rank process it forks
_PRELOAD = ["torch", "torch.distributed", "numpy", "repro_torch.dist.ranks",
            "repro_torch.dist.tensor_parallel", "repro_torch.launch.train",
            "repro_torch.models.transformer", "repro_torch.train.checkpoint",
            "repro_torch.train.train_step"]


class _Inherited:
    """The parent's file descriptor ``fd`` as of the call, handed to a
    child (a fork server's child otherwise writes where the server was
    started): pickled, it becomes the child's copy of it."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        return _detach, (reduction.DupFd(self.fd),)


def _detach(dup) -> int:
    return dup.detach()


def _send(jobs) -> None:
    """Write each rank its pickled call (a thread: a pipe takes ~64 KB
    before its reader reads)."""
    for conn, payload in jobs:
        try:
            conn.send_bytes(payload)
        except OSError:         # the rank is gone; its world fails
            pass
        finally:
            conn.close()


def _child(rank, world, readers, tmp, backend, device, timeout, stdout,
           stderr, transport, mailbox_bytes):
    global _MAILBOX
    for fd, to in ((stdout, 1), (stderr, 2)):
        os.dup2(fd, to)
        os.close(fd)
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 means IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        fn, args, kwargs, env = readers[rank].recv()
        for conn in readers:
            conn.close()
        os.environ.clear()      # the parent's at the call, not the server's
        os.environ.update(env)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        if transport == "device":
            _MAILBOX = Mailbox(device, os.path.join(tmp, "mailbox"), timeout,
                               mailbox_bytes)
        out = fn(rank, world, *args, device=device, **kwargs)
        if _MAILBOX is not None:
            _MAILBOX.close()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt.tmp"))
        os.replace(os.path.join(tmp, f"rank{rank}.pt.tmp"),
                   os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:       # sys.exit in a rank too
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        # a failed rank leaves its mailbox mapped: its peers may still read
        # it, and the parent stops the whole world
        _MAILBOX = None
        if dist.is_initialized():
            dist.destroy_process_group()


def run_jobs(rank: int, world: int, jobs: Sequence, *, device) -> list:
    """Run several rank functions in one world, in order:
    ``jobs = [(fn, args, kwargs)]``, each called as ``fn(rank, world,
    *args, device=device, **kwargs)``; returns their results."""
    return [fn(rank, world, *args, device=device, **kwargs)
            for fn, args, kwargs in jobs]


def rank_probe(rank: int, world: int, fail: Optional[int] = None,
               hang: Optional[int] = None, how: str = "raise", *,
               device) -> List[str]:
    """The top-level packages this rank process has imported. Rank
    ``fail`` raises (``how`` "raise"), calls ``sys.exit`` ("exit") or
    dies by SIGKILL ("kill"), rank ``hang`` sleeps for good, and with
    either the other ranks wait in a barrier that never completes: the
    faults :func:`spawn_ranks` must turn into an error within its
    deadline."""
    if rank == fail:
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if how == "exit":
            sys.exit(f"rank {rank} exits on purpose")
        raise RuntimeError(f"rank {rank} fails on purpose")
    if rank == hang:
        time.sleep(1e9)
    if fail is not None or hang is not None:
        dist.barrier()
    return sorted({name.split(".")[0] for name in sys.modules})


class _InFlight:
    """One rank's part of an exchange in flight: the collective's work
    handles, the buffer being sent (kept alive until they complete) and,
    where the rank receives, the host buffer and the slots it lands at."""

    def __init__(self, transport, works, send, recv, slots):
        self.transport, self.works = transport, works
        self.send, self.recv, self.slots = send, recv, slots

    def wait(self):
        """Wait for the exchange; returns ``(slots, received blocks on the
        device)``, or None where the rank received nothing."""
        t0 = time.perf_counter()
        for work in self.works:
            work.wait()
        self.send = None
        got = (None if self.slots is None
               else (self.slots, self.transport.stage_in(self.recv)))
        self.transport.ms += 1e3 * (time.perf_counter() - t0)
        return got


class _Counted:
    """What every transport counts: ``bytes[kind][p]`` and
    ``msgs[kind][p]``, what this rank sent to rank p, by the transport's
    ``KINDS``; ``staged_bytes`` and ``stage_ms``, the bytes copied through
    host memory and the host time of the copies out (0 on the device
    transport)."""

    KINDS: tuple = ()

    def __init__(self, device, world: int):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device is cuda but "
                               "torch.cuda.is_available() is False")
        self.world = world

    def _reset_counts(self) -> None:
        self.bytes = {k: [0] * self.world for k in self.KINDS}
        self.msgs = {k: [0] * self.world for k in self.KINDS}
        self.staged_bytes = 0
        self.stage_ms = 0.0

    def _count(self, kind: str, peers, nbytes: int) -> None:
        sent = self.bytes.setdefault(kind, [0] * self.world)
        msgs = self.msgs.setdefault(kind, [0] * self.world)
        for p in peers:
            sent[p] += nbytes
            msgs[p] += 1

    @staticmethod
    def _kind(t: torch.Tensor, kind: str) -> str:
        return "scalar" if t.numel() == 1 else kind


class _Staged(_Counted):
    """What both gloo transports share: gloo moves host tensors only, so on
    the card every buffer is staged explicitly. The rank waits for its
    stream (:meth:`_drain`), copies the tensor into pinned host memory
    (:meth:`stage_out`), hands it to gloo, and copies what it receives
    back to ``device`` (:meth:`stage_in`); ``staged_bytes`` counts both
    directions and ``stage_ms`` the host time of the copies out. On the
    CPU tensors go as they are."""

    name = "gloo"

    def __init__(self, device, world: int):
        super().__init__(device, world)
        self.staged = self.device.type == "cuda"

    def _drain(self) -> float:
        """Wait for the rank's stream; returns the host clock."""
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host buffer for gloo to receive into (pinned on the card)."""
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.staged)

    def stage_out(self, t: torch.Tensor) -> torch.Tensor:
        """The host buffer gloo sends: a pinned copy of ``t`` on the card
        (the copy waits for the stream), ``t`` itself on the CPU when
        contiguous."""
        t = t.detach().contiguous()
        if not self.staged:
            return t
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += host.nbytes
        self.stage_ms += 1e3 * (time.perf_counter() - t0)
        return host

    def stage_in(self, host: torch.Tensor,
                 into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """What gloo received in ``host``, on ``device``: copied into
        ``into`` when given (nothing to do where ``host`` is ``into``)."""
        if into is not None and host.data_ptr() == into.data_ptr():
            return into
        if self.staged:
            self.staged_bytes += host.nbytes
        if into is None:
            return host.to(self.device, non_blocking=True)
        return into.copy_(host, non_blocking=self.staged)


class HostTransport(_Staged):
    """A block executor's exchanges between the ranks of a gloo process
    group, through host memory (staged as :class:`_Staged` says).

    - a dense exchange is one ``all_to_all_single`` over a ``[world, M, b0,
      b1]`` buffer: row p goes to rank p, the rank's own row included (gloo
      copies it within the process; ``comm_stats`` counts it as wire);
    - a sparse round is one ``batch_isend_irecv`` of at most one send and
      one receive (a round is a partial permutation).

    Both are issued with ``async_op`` and complete in :meth:`_InFlight.wait`
    (the executor's ``land``), so under ``overlap`` the next wavefront's
    halo-independent compute runs while the blocks travel.
    ``bytes["blocks"][p]`` and ``msgs["blocks"][p]`` count what this rank
    sent to rank p; ``ms`` is the host time spent issuing and waiting,
    after the stream has drained (so no compute is counted in it), and
    ``stage_ms`` the part of it spent copying gathered blocks to pinned
    memory.
    """

    KINDS = ("blocks",)

    def __init__(self, group, device, block_shape, dtype):
        self.group = group
        self.rank = dist.get_rank(group)
        super().__init__(device, dist.get_world_size(group))
        self.block_shape = tuple(block_shape)
        self.dtype = dtype
        self.reset()

    def reset(self) -> None:
        self._reset_counts()
        self.ms = 0.0

    def _blocks(self, *lead) -> torch.Tensor:
        return self._empty((*lead, *self.block_shape), self.dtype)

    def _peer(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def all_to_all(self, buf: torch.Tensor, slots: torch.Tensor) -> _InFlight:
        """Issue one dense exchange: ``buf [world, M, b0, b1]``, row p for
        rank p; the rows received from each source land at ``slots
        [world, M]``."""
        t0 = self._drain()
        send = self.stage_out(buf)
        recv = self._blocks(*send.shape[:2])
        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=True)
        for p in range(self.world):
            self._count("blocks", [p], send[p].nbytes)
        self.ms += 1e3 * (time.perf_counter() - t0)
        return _InFlight(self, [work], send, recv, slots)

    def permute(self, buf: Optional[torch.Tensor], to: Optional[int],
                frm: Optional[int], slots: torch.Tensor) -> _InFlight:
        """Issue this rank's part of one sparse round: send ``buf`` to rank
        ``to`` and/or receive ``len(slots)`` blocks from rank ``frm``,
        landing at ``slots``."""
        t0 = self._drain() if to is not None else time.perf_counter()
        ops, send, recv = [], None, None
        if to is not None:
            send = self.stage_out(buf)
            ops.append(dist.P2POp(dist.isend, send, self._peer(to),
                                  self.group))
            self._count("blocks", [to], send.nbytes)
        if frm is not None:
            recv = self._blocks(slots.shape[0])
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(frm),
                                  self.group))
        works = dist.batch_isend_irecv(ops)
        self.ms += 1e3 * (time.perf_counter() - t0)
        return _InFlight(self, works, send, recv,
                         slots if frm is not None else None)


class TensorTransport(_Staged):
    """Tensors between the ranks of a gloo world, through host memory
    (staged as :class:`_Staged` says).

    - :meth:`send` (``isend``: the caller goes on computing while it
      travels; :meth:`wait_sends` completes every send in flight) and
      :meth:`recv` move a tensor as its bytes, so any dtype crosses (gloo's
      typed ops may not take bf16);
    - :meth:`all_reduce` sums an f32 tensor over a sub-group in place, and
      refuses any other dtype: every reduction stays in f32;
    - :meth:`broadcast` sends a tensor from one rank of a sub-group to the
      others, in place;
    - :meth:`all_gather` returns every member's tensor of a sub-group, as
      bytes (any dtype).

    Peers are global ranks. The kinds counted are ``"p2p"``, the sends;
    ``"reduce"``, the all-reduces (the tensor's bytes to each other
    member: what a pair exchanges; broadcasts count as ``"p2p"`` from
    their source); ``"gather"``, the all-gathers (the rank's own tensor's
    bytes to each other member); ``"scalar"``, any message of one
    element. An all-reduce or an all-gather may name a kind of its own
    (the ranked train step's ``"grad"`` and ``"replica"``, the elastic
    launcher's heartbeats, ``"beat"``), counted from its first use.
    ``ms[kind]``
    is the host time spent in each kind, waits for the peers included,
    after the stream has drained. :meth:`busy_ms` is the time the rank's
    stream spent between exchanges (CUDA events; the host clock on the
    CPU). A group of one rank exchanges nothing."""

    KINDS = ("p2p", "reduce", "gather", "scalar")

    def __init__(self, device):
        super().__init__(device, dist.get_world_size())
        self._sends: list = []
        self.reset()

    def reset(self) -> None:
        """Zero the counters and start the busy clock."""
        self._reset_counts()
        self.ms = {k: 0.0 for k in self.KINDS}
        self._spans: list = []
        self._mark = self._now()

    def _now(self):
        if not self.staged:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _enter(self) -> float:
        """Close the compute span since the last exchange; drain the
        stream. Returns the host clock."""
        self._spans.append((self._mark, self._now()))
        return self._drain()

    def _leave(self, kind: str, t0: float) -> None:
        self.ms[kind] = self.ms.get(kind, 0.0) \
            + 1e3 * (time.perf_counter() - t0)
        self._mark = self._now()

    def busy_ms(self) -> float:
        """Milliseconds of the rank's stream between exchanges since
        :meth:`reset`, up to now (synchronises)."""
        spans = self._spans + [(self._mark, self._now())]
        if not self.staged:
            return 1e3 * sum(b - a for a, b in spans)
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in spans)

    def send(self, t: torch.Tensor, to: int, tag: int = 0) -> None:
        """Start sending ``t`` to rank ``to``; the host copy stays alive
        until :meth:`wait_sends`."""
        t0 = self._enter()
        host = self.stage_out(t)
        work = dist.isend(_bytes_of(host), to, tag=tag)
        self._sends.append((work, host))
        kind = self._kind(t, "p2p")
        self._count(kind, [to], host.nbytes)
        self._leave(kind, t0)

    def wait_sends(self) -> None:
        """Complete every send in flight."""
        t0 = time.perf_counter()
        for work, _ in self._sends:
            work.wait()
        self._sends.clear()
        self.ms["p2p"] += 1e3 * (time.perf_counter() - t0)

    def recv(self, shape, dtype: torch.dtype, frm: int,
             tag: int = 0) -> torch.Tensor:
        """Receive a tensor of ``shape`` and ``dtype`` from rank ``frm``;
        returns it on ``device``."""
        t0 = self._enter()
        host = self._empty(shape, dtype)
        dist.recv(_bytes_of(host), frm, tag=tag)
        out = self.stage_in(host)
        self._leave(self._kind(host, "p2p"), t0)
        return out

    def all_reduce(self, t: torch.Tensor, group, kind: str = "reduce"
                   ) -> torch.Tensor:
        """Sum the f32 tensor ``t`` over ``group``, in place; returns it.
        Its bytes count under ``kind`` (one element: ``"scalar"``)."""
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce takes f32 only (every reduction "
                            f"stays in f32), got {t.dtype}")
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return t
        t0 = self._enter()
        host = self.stage_out(t)
        dist.all_reduce(host, group=group)
        self.stage_in(host, into=t)
        kind = self._kind(t, kind)
        self._count(kind, [p for p in members if p != dist.get_rank()],
                    host.nbytes)
        self._leave(kind, t0)
        return t

    def all_gather(self, t: torch.Tensor, group, kind: str = "gather"
                   ) -> List[torch.Tensor]:
        """Each member's ``t`` (one shape and dtype on every member) on
        ``device``, in the group's rank order; ``[t]`` in a group of
        one. Its bytes count under ``kind`` (one element: ``"scalar"``)."""
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return [t]
        t0 = self._enter()
        host = self.stage_out(t)
        parts = [self._empty(host.shape, host.dtype) for _ in members]
        dist.all_gather([_bytes_of(p) for p in parts],
                        _bytes_of(host), group=group)
        out = [self.stage_in(p) for p in parts]
        kind = self._kind(t, kind)
        self._count(kind, [p for p in members if p != dist.get_rank()],
                    host.nbytes)
        self._leave(kind, t0)
        return out

    def broadcast(self, t: torch.Tensor, src: int, group) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank of ``group``, in place;
        returns it."""
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return t
        t0 = self._enter()
        host = self.stage_out(t)
        dist.broadcast(_bytes_of(host), src, group=group)
        self.stage_in(host, into=t)
        kind = self._kind(t, "p2p")
        if dist.get_rank() == src:
            self._count(kind, [p for p in members if p != src], host.nbytes)
        self._leave(kind, t0)
        return t


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


# A message's channel: point-to-point messages of one tag, the block
# executor's sparse rounds, or the collectives of one group (its members'
# global ranks as a bit mask). Both ends count a pair's messages on a
# channel in program order, so a key (channel, count) names one message.
def _p2p_channel(tag: int) -> int:
    if not 0 <= tag < 1 << 28:
        raise ValueError(f"tag {tag} outside [0, 2**28)")
    return 4 * tag


_ROUNDS = 2


def _group_channel(members: Sequence[int]) -> int:
    return 4 * sum(1 << m for m in members) + 1


class _CudaBytes:
    """``nbytes`` of device memory at ``ptr`` for ``torch.as_tensor``
    (the CUDA array interface): the tensor neither owns nor frees it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


class Mailbox:
    """This rank's end of the device transport: a buffer of ``nbytes`` the
    rank publishes into and its peers read from, the peers' buffers mapped
    here, and a control table in shared host memory. Made once a world, by
    every rank together (``spawn_ranks(transport="device")``), on
    ``device``:

    - on ``cuda`` the buffer is device memory outside PyTorch's caching
      allocator (``kernels/csrc/mailbox.cu``: ``cudaMalloc``, exported by
      ``cudaIpcGetMemHandle``, opened in each peer by
      ``cudaIpcOpenMemHandle``), and IPC events (``torch.cuda.Event(
      interprocess=True)``) order the copies across processes; the handles
      go round once through the world's gloo group (``all_gather_object``).
      A handle that fails to open raises;
    - on the CPU the buffer is a file in ``root`` mapped shared
      (``torch.from_file(..., shared=True)``) and the copies are
      synchronous, so the same protocol runs without events.

    A message is at most ``piece`` bytes (a larger tensor goes in pieces)
    and takes one of ``SLOTS`` descriptors of the writer's row of the
    table: ``ctl[writer, slot]`` holds its offset and length in the
    writer's buffer, a key for each reader and each reader's
    acknowledgement. Each entry has one writer: the row's owner writes
    offset, length and keys, reader r only its acknowledgement.

    - Publish (:meth:`publish`): take a descriptor and a range of the
      buffer whose earlier readers have all acknowledged (the writer's
      stream first waits on each one's "consumed" event), copy the piece
      in on the rank's stream, record the descriptor's event, write offset
      and length, then the keys.
    - Read (:meth:`take`, then :meth:`release`): poll the writer's row for
      the key with a backoff, for at most the world's ``timeout`` (then
      ``TimeoutError``); make the stream wait on the writer's event; copy
      or sum out of the writer's buffer; record this reader's consumed
      event; write the acknowledgement.

    The key is written only after the event is recorded (a stream that
    waits on an event before its record waits on nothing), and a
    descriptor's event is recorded again only after every reader has
    acknowledged, that is, issued its wait. No kernel spins on a flag that
    another process writes: ranks on one card without MPS are
    time-sliced, and a spinning kernel would starve the peer it waits for.
    Receives issued ahead (:meth:`incoming`) are ``pending``; a rank that
    waits, for room or for a message, lands those that have arrived, so
    that ranks waiting for room in each other's buffers do not wait on
    each other."""

    SLOTS = 32
    ALIGN = 512

    @classmethod
    def check_size(cls, nbytes: int) -> None:
        if nbytes < 8 * cls.ALIGN:
            raise ValueError(f"a mailbox of {nbytes} bytes: at least "
                             f"{8 * cls.ALIGN}")

    def __init__(self, device, root: str, timeout: float,
                 nbytes: int = MAILBOX_BYTES):
        self.check_size(nbytes)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.timeout, self.nbytes = timeout, nbytes
        self.piece = nbytes // 8 // self.ALIGN * self.ALIGN
        W = self.world
        self._key_col, self._ack_col = 2, 2 + W
        os.makedirs(root, exist_ok=True)
        self._ctl = torch.from_file(os.path.join(root, "ctl"), shared=True,
                                    size=W * self.SLOTS * (2 + 2 * W),
                                    dtype=torch.int64)
        self.ctl = self._ctl.numpy().reshape(W, self.SLOTS, 2 + 2 * W)
        self._lib, self._ptr, self._opened = None, None, []
        if self.cuda:
            self._map_device()
        else:
            self._map_files(root)
        self.box = self.boxes[self.rank]
        self.live: Dict[int, tuple] = {}      # slot: (offset, length, keys)
        self.free = list(range(self.SLOTS))
        self.head = 0
        self.sent: Dict[tuple, int] = {}       # (reader, channel): count
        self.got: Dict[tuple, int] = {}        # (writer, channel): count
        self.pending: List[_Incoming] = []

    def _map_files(self, root: str) -> None:
        def box(r):
            return torch.from_file(os.path.join(root, f"box{r}"),
                                   shared=True, size=self.nbytes,
                                   dtype=torch.uint8)

        own = box(self.rank)
        dist.all_gather_object([None] * self.world, None)   # all exist
        self.boxes = [own if r == self.rank else box(r)
                      for r in range(self.world)]

    def _map_device(self) -> None:
        import ctypes

        from repro_torch.kernels import _build

        lib = self._lib = _build.load("mailbox")
        out = ctypes.POINTER(ctypes.c_void_p)
        lib.mailbox_handle_size.restype = ctypes.c_int
        for fn, args in ((lib.mailbox_alloc, (ctypes.c_size_t, out)),
                         (lib.mailbox_free, (ctypes.c_void_p,)),
                         (lib.mailbox_export, (ctypes.c_void_p,
                                               ctypes.c_char_p)),
                         (lib.mailbox_open, (ctypes.c_char_p, out)),
                         (lib.mailbox_close, (ctypes.c_void_p,))):
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.mailbox_error.argtypes = (ctypes.c_int,)
        lib.mailbox_error.restype = ctypes.c_char_p
        torch.cuda.init()
        # IPC events are opened on a device with its index
        self.device = torch.device("cuda", torch.cuda.current_device())
        ptr = ctypes.c_void_p()
        self._check(lib.mailbox_alloc(self.nbytes, ctypes.byref(ptr)),
                    f"cudaMalloc of {self.nbytes} bytes")
        self._ptr = ptr.value
        handle = ctypes.create_string_buffer(lib.mailbox_handle_size())
        self._check(lib.mailbox_export(self._ptr, handle),
                    "cudaIpcGetMemHandle")
        W, D = self.world, self.SLOTS

        def events():
            return [torch.cuda.Event(interprocess=True) for _ in range(D)]

        # this rank's events: one a slot of its own buffer ("published"),
        # and one a slot of each peer's ("consumed" by this rank)
        self.pub = events()
        self.used = {w: events() for w in range(W) if w != self.rank}
        mine = (handle.raw, [e.ipc_handle() for e in self.pub],
                {w: [e.ipc_handle() for e in evs]
                 for w, evs in self.used.items()})
        info = [None] * W
        dist.all_gather_object(info, mine)
        self.boxes = []
        for r, (mem, _, _) in enumerate(info):
            if r == self.rank:
                at = self._ptr
            else:
                got = ctypes.c_void_p()
                self._check(lib.mailbox_open(mem, ctypes.byref(got)),
                            f"cudaIpcOpenMemHandle of rank {r}'s mailbox")
                at = got.value
                self._opened.append(at)
            self.boxes.append(torch.as_tensor(_CudaBytes(at, self.nbytes),
                                              device=self.device))
        peers = [r for r in range(W) if r != self.rank]
        self.peer_pub = {r: [torch.cuda.Event.from_ipc_handle(self.device, h)
                             for h in info[r][1]] for r in peers}
        self.peer_used = {r: [torch.cuda.Event.from_ipc_handle(self.device,
                                                              h)
                              for h in info[r][2][self.rank]] for r in peers}

    def _check(self, err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"mailbox of rank {self.rank}: {what} failed: "
                               f"{self._lib.mailbox_error(err).decode()} "
                               f"({err})")

    def close(self) -> None:
        """Once every rank of the world is done (a barrier after this
        rank's stream has drained, so no peer still reads this buffer):
        unmap the peers' buffers and free this rank's."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        dist.barrier()
        self.boxes = self.box = None
        self.pending.clear()
        if self.cuda:
            for at in self._opened:
                self._check(self._lib.mailbox_close(at),
                            "cudaIpcCloseMemHandle")
            self._check(self._lib.mailbox_free(self._ptr), "cudaFree")
            self._opened, self._ptr = [], None

    def _stream(self):
        return torch.cuda.current_stream(self.device)

    @staticmethod
    def _key(counts: Dict[tuple, int], peer: int, chan: int) -> int:
        n = counts.get((peer, chan), 0) + 1
        counts[(peer, chan)] = n
        return (chan << 32) | n

    def _until(self, probe, what: str):
        """``probe()`` once it is not None, landing pending receives
        between polls; raises ``TimeoutError`` after the world's
        ``timeout``."""
        deadline = time.monotonic() + self.timeout
        polls = 0
        while True:
            got = probe()
            if got is not None:
                return got
            self.pump()
            polls += 1
            if polls > 64:
                time.sleep(min(1e-3, 2e-6 * (polls - 64)))
            if time.monotonic() > deadline:
                raise TimeoutError(f"mailbox of rank {self.rank}: waited "
                                   f"{self.timeout} s for {what}")

    # -- the writer's side

    def _reclaim(self) -> None:
        """Free the slots whose readers have all acknowledged; the stream
        waits on their consumed events before the range is written again."""
        for slot, (_, _, keys) in list(self.live.items()):
            acks = self.ctl[self.rank, slot, self._ack_col:]
            if all(acks[r] == k for r, k in keys):
                if self.cuda:
                    for r, _ in keys:
                        self._stream().wait_event(self.peer_used[r][slot])
                del self.live[slot]
                self.free.append(slot)

    def _fit(self, n: int) -> Optional[int]:
        """An offset where ``n`` bytes overlap no live message: from the
        last one's end, else the first that fits."""
        spans = sorted((off, off + -(-ln // self.ALIGN) * self.ALIGN)
                       for off, ln, _ in self.live.values())
        for at in [self.head] + [end for _, end in spans] + [0]:
            if at + n <= self.nbytes and all(at + n <= a or at >= b
                                             for a, b in spans):
                return at
        return None

    def _room(self, n: int) -> tuple:
        def probe():
            self._reclaim()
            at = self._fit(n) if self.free else None
            return None if at is None else (self.free.pop(0), at)

        slot, at = self._until(probe, f"room for {n} bytes in its own "
                               f"mailbox ({len(self.live)} messages unread)")
        self.head = at + -(-n // self.ALIGN) * self.ALIGN
        return slot, at

    def publish(self, piece: torch.Tensor, readers: Sequence[int],
                chan: int) -> torch.Tensor:
        """Publish ``piece`` (flat uint8, at most ``piece`` bytes) to the
        global ranks ``readers``; returns its copy in this rank's buffer."""
        n = piece.numel()
        keys = [(r, self._key(self.sent, r, chan)) for r in readers]
        slot, at = self._room(n)
        self.box[at:at + n].copy_(piece)
        if self.cuda:
            self.pub[slot].record()
        row = self.ctl[self.rank, slot]
        row[0], row[1] = at, n
        for r, k in keys:
            row[self._key_col + r] = k
        self.live[slot] = (at, n, keys)
        return self.box[at:at + n]

    def send(self, data: torch.Tensor, readers: Sequence[int],
             chan: int) -> None:
        """Publish ``data`` (flat uint8) to ``readers`` piece by piece."""
        for a in range(0, data.numel(), self.piece):
            self.publish(data[a:a + self.piece], readers, chan)

    # -- the reader's side

    def _find(self, src: int, key: int) -> Optional[int]:
        hits = np.flatnonzero(
            self.ctl[src, :, self._key_col + self.rank] == key)
        return int(hits[0]) if hits.size else None

    def _open(self, src: int, slot: int) -> torch.Tensor:
        """The message in ``src``'s ``slot``, once the stream has waited
        for its copy."""
        at, n = (int(v) for v in self.ctl[src, slot, :2])
        if self.cuda:
            self._stream().wait_event(self.peer_pub[src][slot])
        return self.boxes[src][at:at + n]

    def expect(self, src: int, chan: int) -> int:
        """The key of the next message from ``src`` on ``chan``."""
        return self._key(self.got, src, chan)

    def take(self, src: int, key: int) -> tuple:
        """Wait for the message ``key`` from ``src``: ``(slot, its
        bytes)``, to read on the stream and :meth:`release`."""
        slot = self._until(lambda: self._find(src, key),
                           f"a message from rank {src}")
        return slot, self._open(src, slot)

    def release(self, src: int, slot: int, key: int) -> None:
        """This rank has read (enqueued its reads of) ``src``'s ``slot``."""
        if self.cuda:
            self.used[src][slot].record()
        self.ctl[src, slot, self._ack_col + self.rank] = key

    def incoming(self, src: int, into: torch.Tensor, chan: int,
                 pending: bool = True) -> "_Incoming":
        """A receive of ``into`` (flat uint8) from ``src``, issued now; with
        ``pending`` it lands whenever this rank waits."""
        got = _Incoming(self, src, into, chan)
        if pending:
            self.pending.append(got)
        return got

    def pump(self) -> None:
        """Land the pending receives whose messages have arrived."""
        if self.pending:
            self.pending = [p for p in self.pending if not p.poll()]

    def land(self, receives: Sequence["_Incoming"]) -> None:
        """Wait until every one of ``receives`` has landed."""
        self._until(lambda: True if all([p.poll() for p in receives])
                    else None, f"messages from ranks "
                    f"{sorted({p.src for p in receives})}")
        self.pending = [p for p in self.pending if p not in receives]


class _Incoming:
    """A receive of ``into`` from rank ``src``: its pieces' keys, taken in
    program order when issued, and the pieces still to land."""

    def __init__(self, box: Mailbox, src: int, into: torch.Tensor,
                 chan: int):
        self.box, self.src = box, src
        self.left = [(box.expect(src, chan), into[a:a + box.piece])
                     for a in range(0, into.numel(), box.piece)]

    def poll(self) -> bool:
        """Land the pieces that have arrived, in order; True once all
        have."""
        while self.left:
            key, dst = self.left[0]
            slot = self.box._find(self.src, key)
            if slot is None:
                return False
            got = self.box._open(self.src, slot)
            if got.numel() != dst.numel():
                raise RuntimeError(
                    f"mailbox of rank {self.box.rank}: rank {self.src} sent "
                    f"{got.numel()} bytes where {dst.numel()} were expected")
            dst.copy_(got)
            self.box.release(self.src, slot, key)
            self.left.pop(0)
        return True


class _Spans:
    """Spans of the rank's stream, summed by key: CUDA events on the card
    (read when summed; spans whose events have completed are folded in as
    they pile up), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device, self.cuda = device, device.type == "cuda"
        self.open: list = []
        self.total: Dict[object, float] = {}

    def now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, key, a, b) -> None:
        if not self.cuda:
            self.total[key] = self.total.get(key, 0.0) + 1e3 * (b - a)
            return
        self.open.append((key, a, b))
        if len(self.open) > 1024:
            self._fold(all_done=False)

    def _fold(self, all_done: bool) -> None:
        keep = []
        for key, a, b in self.open:
            if all_done or b.query():
                self.total[key] = self.total.get(key, 0.0) + a.elapsed_time(b)
            else:
                keep.append((key, a, b))
        self.open = keep

    def ms(self) -> Dict[object, float]:
        """Milliseconds by key so far (synchronises on the card)."""
        if self.cuda and self.open:
            torch.cuda.synchronize(self.device)
            self._fold(all_done=True)
        return dict(self.total)


def _on_box(cls, box: Mailbox, device) -> None:
    if torch.device(device).type != box.device.type:
        raise ValueError(f"{cls.__name__} on {device}: the world's mailbox "
                         f"is on {box.device}")


class _Landing:
    """A device exchange in flight: its receives and where they land."""

    def __init__(self, transport, receives, recv, slots):
        self.transport, self.receives = transport, receives
        self.recv, self.slots = recv, slots

    def wait(self):
        """Wait for the exchange; returns ``(slots, received blocks on the
        device)``, or None where the rank received nothing."""
        spans = self.transport._spans
        t0 = spans.now()
        self.transport.box.land(self.receives)
        spans.add("exchange", t0, spans.now())
        return None if self.slots is None else (self.slots, self.recv)


class DeviceTransport(_Counted):
    """A block executor's exchanges between the ranks of ``group`` through
    the world's :class:`Mailbox`: the interface of
    :class:`HostTransport`, with nothing staged through the host.

    - a dense exchange (:meth:`all_to_all`) publishes row p of the buffer
      to rank p, one message each, and keeps its own row (``comm_stats``
      counts it as wire, as :class:`HostTransport` does);
    - a sparse round (:meth:`permute`) publishes at most one message and
      receives at most one.

    Both register their receives before they publish and return at once;
    :meth:`_Landing.wait` (the executor's ``land``) waits for them, so
    under ``overlap`` the next wavefront's halo-independent compute is
    enqueued while the peers publish. The blocks are copied, so the
    result is bit for bit the gloo transport's. ``ms`` is the time of the
    exchanges' own work on the rank's stream (CUDA events around the
    publishing and around the landing, the waits for the peers' copies
    included; the host clock on the CPU), not the host time that
    :class:`HostTransport` counts; ``staged_bytes`` and ``stage_ms`` are
    0."""

    KINDS = ("blocks",)
    name = "device"

    def __init__(self, box: Mailbox, group, device, block_shape, dtype):
        _on_box(type(self), box, device)
        self.box, self.group = box, group
        self.rank = dist.get_rank(group)
        super().__init__(device, dist.get_world_size(group))
        self.members = dist.get_process_group_ranks(group)
        self.chan = _group_channel(self.members)
        self.block_shape, self.dtype = tuple(block_shape), dtype
        self.mailbox_bytes = box.nbytes
        self.reset()

    def reset(self) -> None:
        self._reset_counts()
        self._spans = _Spans(self.device)

    @property
    def ms(self) -> float:
        return self._spans.ms().get("exchange", 0.0)

    def all_to_all(self, buf: torch.Tensor, slots: torch.Tensor) -> _Landing:
        """Issue one dense exchange: ``buf [world, M, b0, b1]``, row p for
        rank p; the rows received from each source land at ``slots
        [world, M]``."""
        t0 = self._spans.now()
        buf = buf.contiguous()
        recv = torch.empty_like(buf)
        receives = [self.box.incoming(g, _bytes_of(recv[p]), self.chan)
                    for p, g in enumerate(self.members) if p != self.rank]
        for p, g in enumerate(self.members):
            if p == self.rank:
                recv[p].copy_(buf[p])
            else:
                self.box.send(_bytes_of(buf[p]), [g], self.chan)
            self._count("blocks", [p], buf[p].nbytes)
        self._spans.add("exchange", t0, self._spans.now())
        return _Landing(self, receives, recv, slots)

    def permute(self, buf: Optional[torch.Tensor], to: Optional[int],
                frm: Optional[int], slots: torch.Tensor) -> _Landing:
        """Issue this rank's part of one sparse round: send ``buf`` to rank
        ``to`` and/or receive ``len(slots)`` blocks from rank ``frm``,
        landing at ``slots``."""
        t0 = self._spans.now()
        receives, recv = [], None
        if frm is not None:
            recv = torch.empty((slots.shape[0], *self.block_shape),
                               dtype=self.dtype, device=self.device)
            receives.append(self.box.incoming(self.members[frm],
                                              _bytes_of(recv), _ROUNDS))
        if to is not None:
            send = buf.contiguous()
            self.box.send(_bytes_of(send), [self.members[to]], _ROUNDS)
            self._count("blocks", [to], send.nbytes)
        self._spans.add("exchange", t0, self._spans.now())
        return _Landing(self, receives, recv,
                        slots if frm is not None else None)


class DeviceTensorTransport(_Counted):
    """Tensors between the ranks of a world through its :class:`Mailbox`:
    the interface of :class:`TensorTransport` (the same kinds and counts),
    with nothing staged through the host.

    - :meth:`send` publishes and returns (the tensor is copied into the
      mailbox on the stream; :meth:`wait_sends` has nothing left to do);
      :meth:`recv` takes the message of that tag from that rank, whatever
      was sent before it on other tags;
    - :meth:`all_reduce` (f32 only): each member publishes its tensor, and
      every member sums the members' copies in the group's rank order as
      a balanced tree (:meth:`_sum`), the same expression on every
      member, so that every member holds the same bits (on two members
      ``t0 + t1``, gloo's bits);
    - :meth:`all_gather` and :meth:`broadcast` copy the members' (the
      source's) tensor out of their mailboxes.

    ``ms[kind]`` is the time of each kind's exchanges on the rank's stream
    (CUDA events around each, the waits for the peers' copies included;
    the host clock on the CPU), not the host time that
    :class:`TensorTransport` counts; :meth:`busy_ms` the stream's time
    between exchanges, as there."""

    KINDS = TensorTransport.KINDS
    name = "device"

    def __init__(self, box: Mailbox, device):
        _on_box(type(self), box, device)
        super().__init__(device, dist.get_world_size())
        self.box, self.rank = box, dist.get_rank()
        self.mailbox_bytes = box.nbytes
        self.reset()

    def reset(self) -> None:
        """Zero the counters and start the busy clock."""
        self._reset_counts()
        self._spans = _Spans(self.device)
        self._mark = self._spans.now()

    @property
    def ms(self) -> Dict[str, float]:
        got = self._spans.ms()
        return {**{k: 0.0 for k in self.KINDS},
                **{k: v for k, v in got.items() if k is not None}}

    def busy_ms(self) -> float:
        """Milliseconds of the rank's stream between exchanges since
        :meth:`reset`, up to now (synchronises)."""
        now = self._spans.now()
        self._spans.add(None, self._mark, now)
        self._mark = now
        return self._spans.ms()[None]

    def _enter(self):
        t0 = self._spans.now()
        self._spans.add(None, self._mark, t0)
        return t0

    def _leave(self, kind: str, t0) -> None:
        self._mark = self._spans.now()
        self._spans.add(kind, t0, self._mark)

    def send(self, t: torch.Tensor, to: int, tag: int = 0) -> None:
        """Publish ``t`` to rank ``to`` under ``tag``."""
        t0 = self._enter()
        data = _bytes_of(t.detach().contiguous())
        self.box.send(data, [to], _p2p_channel(tag))
        kind = self._kind(t, "p2p")
        self._count(kind, [to], data.numel())
        self._leave(kind, t0)

    def wait_sends(self) -> None:
        """Nothing to wait for: a send is in the mailbox once it returns."""

    def recv(self, shape, dtype: torch.dtype, frm: int,
             tag: int = 0) -> torch.Tensor:
        """Receive a tensor of ``shape`` and ``dtype`` from rank ``frm``
        under ``tag``; returns it on ``device``."""
        t0 = self._enter()
        out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self.box.land([self.box.incoming(frm, _bytes_of(out),
                                         _p2p_channel(tag), pending=False)])
        self._leave(self._kind(out, "p2p"), t0)
        return out

    @staticmethod
    def _work(t: torch.Tensor) -> torch.Tensor:
        """Where a collective writes ``t``'s result: ``t``'s own memory,
        unless it is strided or autograd would record the write (then a
        copy, written back into ``t`` at the end)."""
        if t.is_contiguous() and not (torch.is_grad_enabled()
                                      and t.requires_grad):
            return t.detach()
        return t.detach().contiguous().clone()

    @staticmethod
    def _sum(parts: List[torch.Tensor], out: torch.Tensor) -> None:
        """``out`` = the members' f32 ``parts``, in the group's rank order,
        summed as a balanced tree: ``(t0 + t1) + (t2 + t3)`` on four
        members, ``t0 + t1`` on two (each path log2(n) roundings instead
        of a chain's n - 1)."""

        def tree(xs, into=None):
            if len(xs) == 1:
                return xs[0]
            half = (len(xs) + 1) // 2
            return torch.add(tree(xs[:half]), tree(xs[half:]), out=into)

        tree(parts, out)

    def all_reduce(self, t: torch.Tensor, group, kind: str = "reduce"
                   ) -> torch.Tensor:
        """Sum the f32 tensor ``t`` over ``group``, in place; returns it.
        Its bytes count under ``kind`` (one element: ``"scalar"``)."""
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce takes f32 only (every reduction "
                            f"stays in f32), got {t.dtype}")
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return t
        t0 = self._enter()
        work = self._work(t)
        flat, data = work.view(-1), _bytes_of(work)
        chan = _group_channel(members)
        others = [m for m in members if m != self.rank]
        for a in range(0, data.numel(), self.box.piece):
            keys = {m: self.box.expect(m, chan) for m in others}
            own = self.box.publish(data[a:a + self.box.piece], others, chan)
            parts, taken = [], []
            for m in members:
                if m == self.rank:
                    parts.append(own)
                    continue
                slot, got = self.box.take(m, keys[m])
                parts.append(got)
                taken.append((m, slot))
            f = [p.view(torch.float32) for p in parts]
            self._sum(f, flat[a // 4:a // 4 + f[0].numel()])
            for m, slot in taken:
                self.box.release(m, slot, keys[m])
        if work.data_ptr() != t.data_ptr():
            t.copy_(work.view_as(t))
        kind = self._kind(t, kind)
        self._count(kind, others, data.numel())
        self._leave(kind, t0)
        return t

    def all_gather(self, t: torch.Tensor, group, kind: str = "gather"
                   ) -> List[torch.Tensor]:
        """Each member's ``t`` (one shape and dtype on every member) on
        ``device``, in the group's rank order; ``[t]`` in a group of
        one. Its bytes count under ``kind`` (one element: ``"scalar"``)."""
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return [t]
        t0 = self._enter()
        src = t.detach().contiguous()
        data = _bytes_of(src)
        chan = _group_channel(members)
        others = [m for m in members if m != self.rank]
        outs = [torch.empty_like(src) for _ in members]
        for a in range(0, data.numel(), self.box.piece):
            receives = [self.box.incoming(m, _bytes_of(outs[i])[
                a:a + self.box.piece], chan, pending=False)
                for i, m in enumerate(members) if m != self.rank]
            own = self.box.publish(data[a:a + self.box.piece], others, chan)
            _bytes_of(outs[members.index(self.rank)])[
                a:a + self.box.piece].copy_(own)
            self.box.land(receives)
        kind = self._kind(t, kind)
        self._count(kind, others, data.numel())
        self._leave(kind, t0)
        return outs

    def broadcast(self, t: torch.Tensor, src: int, group) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank of ``group``, in place;
        returns it."""
        members = dist.get_process_group_ranks(group)
        if len(members) == 1:
            return t
        t0 = self._enter()
        chan = _group_channel(members)
        kind = self._kind(t, "p2p")
        if self.rank == src:
            data = _bytes_of(t.detach().contiguous())
            others = [m for m in members if m != src]
            self.box.send(data, others, chan)
            self._count(kind, others, data.numel())
        else:
            work = self._work(t)
            self.box.land([self.box.incoming(src, _bytes_of(work), chan,
                                             pending=False)])
            if work.data_ptr() != t.data_ptr():
                t.copy_(work.view_as(t))
        self._leave(kind, t0)
        return t


def block_transport(group, device, block_shape, dtype):
    """The block executor's transport on ``group``: the world's
    :class:`DeviceTransport` where the world has a mailbox
    (``spawn_ranks(transport="device")``), else :class:`HostTransport`."""
    if _MAILBOX is None:
        return HostTransport(group, device, block_shape, dtype)
    return DeviceTransport(_MAILBOX, group, device, block_shape, dtype)


def tensor_transport(device):
    """The model path's transport: the world's
    :class:`DeviceTensorTransport` where the world has a mailbox, else
    :class:`TensorTransport`."""
    if _MAILBOX is None:
        return TensorTransport(device)
    return DeviceTensorTransport(_MAILBOX, device)


def owned_blocks(prog, runs: Sequence[dict]) -> Dict[object, torch.Tensor]:
    """``{block id: tensor}`` of the owned blocks that the ranks returned
    from one run each (:func:`run_program`'s ``slots`` and ``row``; halo
    and trash slots are left out)."""
    slot_blk = {(s, slot): blk for blk, (s, slot) in prog.slot_of.items()}
    return {slot_blk[(run["rank"], slot)]: block for run in runs
            for slot, block in zip(run["slots"], run["row"])
            if (run["rank"], slot) in slot_blk}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches so far in this process (B1-B4)."""
    from repro_torch.kernels.block_gemm import block_gemm
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    return {k.__name__: k.launches for k in (block_gemm, flash_attention,
                                             ssd_scan, decode_attention)}


def run_program(prog, bodies, blocks, runs: Sequence[dict], *, device,
                keep: Optional[Sequence[str]] = None, group=None
                ) -> List[dict]:
    """The rank side of a ranked run: pack this rank's shard of ``blocks``
    (``prog.pack_shard``) and run ``prog`` on it once for each entry of
    ``runs``.

    A run is the executor's keyword arguments (``scan``, ``comm``,
    ``overlap``, ``cover``, ... ; ``auto=True`` takes ``auto_executor``
    and its policy arguments instead) plus ``name`` and ``warmup`` (calls
    before the measured one). The measured call starts after a barrier and
    ends after the stream has drained and a second barrier, so its
    ``wall_ms`` on the slowest rank is the world's. Each run returns its
    ``mode``, ``wall_ms``, ``body_ms``, ``exchange_ms`` (and its
    ``stage_ms``, the copies to pinned memory), ``sent_bytes`` and
    ``sent_msgs`` per peer, ``staged_bytes``, the ``transport``'s name and
    its ``mailbox_bytes`` (0 on gloo), ``wire_blocks`` (this rank's
    row of the lowering's tables), body ``calls`` by type, the kernels'
    ``launches`` in the measured call, and ``row``: the rank's store at
    ``slots`` (every slot, or with ``keep`` the rank's own blocks whose id
    starts with one of those kinds), on the CPU."""
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    dev = torch.device(device)
    row = prog.pack_shard(blocks, rank, dev)
    slots = (list(range(prog.n_slots)) if keep is None else
             sorted(slot for blk, (s, slot) in prog.slot_of.items()
                    if s == rank and blk[0] in keep))

    def drain():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for run in runs:
        kw = dict(run)
        name, warmup = kw.pop("name", ""), kw.pop("warmup", 0)
        make = prog.auto_executor if kw.pop("auto", False) else prog.executor
        ex = make(bodies, device=dev, group=group, **kw)
        for _ in range(warmup):
            ex(row)
        drain()
        ex.reset()
        before = launch_counts()
        dist.barrier(group)
        t0 = time.perf_counter()
        got = ex(row)
        drain()
        dist.barrier(group)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        after = launch_counts()
        out.append({
            "name": name, "mode": ex.mode, "rank": rank, "wall_ms": wall_ms,
            "body_ms": ex.body_ms, "exchange_ms": ex.transport.ms,
            "stage_ms": ex.transport.stage_ms,
            "sent_bytes": list(ex.transport.bytes["blocks"]),
            "sent_msgs": list(ex.transport.msgs["blocks"]),
            "staged_bytes": ex.transport.staged_bytes,
            "transport": ex.transport.name,
            "mailbox_bytes": getattr(ex.transport, "mailbox_bytes", 0),
            "wire_blocks": ex.wire_blocks[rank].tolist(),
            "calls": dict(ex.calls), "max_batch": dict(ex.max_batch),
            "launches": {k: after[k] - before[k] for k in after},
            "slots": slots, "row": got[0, slots].cpu()})
        del got, ex
    return out
