"""One process per shard: start a world of rank processes, move blocks
between them, and run a block program on each rank.

The JAX package's block executor is SPMD over a mesh of one device per
shard (``repro.core.schedule``: ``shard_map``, ``all_to_all``,
``ppermute``). Here each shard is a process, and the exchanges are
``torch.distributed`` collectives between them:

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
- :class:`HostTransport` is the transport: gloo, with blocks of stores on
  the card staged through pinned host buffers explicitly (gloo moves host
  memory only; the staging and the counts per peer are :class:`_Staged`'s,
  which both transports share). It counts the messages and bytes it sends
  to each peer, the bytes it stages, and the host time the exchanges
  take. Ranks that share one card cannot use NCCL (it refuses two ranks
  on one device), so on one card the exchange always crosses the host.
- :class:`TensorTransport` is the model path's transport on a mesh of
  ranks (``launch.mesh.Mesh(..., group=)``), staged through pinned host
  memory the same way: point-to-point sends and receives of tensors of any
  shape and dtype (the pipeline's activations and their gradients, moved
  as bytes), f32 all-reduces over a sub-group (gradients, mask counts,
  tensor-parallel partial products), all-gathers (vocab-sharded logits)
  and broadcasts; it counts bytes and messages per peer by kind.
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

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


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
                **kwargs) -> List[object]:
    """Run ``fn(rank, world, *args, device=device, **kwargs)`` in ``world``
    new processes joined into one ``torch.distributed`` group; return the
    ranks' results in rank order.

    The group meets through a file in a temporary directory (no port to
    collide with other worlds) and its collectives time out after
    ``timeout`` seconds; the whole call, start-up included, has the same
    deadline. Each child runs IEEE f32 matmuls (TF32 off) and, on the CPU,
    one thread. On ``cuda`` every kernel is built here, once, before the
    children load it; without a GPU the call raises before it spawns.

    Raises ``RuntimeError`` with the children's tracebacks as soon as a
    rank raises, exits or dies (:class:`RankDied`, naming the ranks that
    a signal killed, where some did), ``TimeoutError`` if the world
    misses the deadline; either way every child is killed before it
    returns."""
    dev = torch.device(device)
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
                          str(dev), timeout, _Inherited(1), _Inherited(2)),
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
           stderr):
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
        out = fn(rank, world, *args, device=device, **kwargs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt.tmp"))
        os.replace(os.path.join(tmp, f"rank{rank}.pt.tmp"),
                   os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:       # sys.exit in a rank too
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
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


class _Staged:
    """What both transports share: gloo moves host tensors only, so on the
    card every buffer is staged explicitly. The rank waits for its stream
    (:meth:`_drain`), copies the tensor into pinned host memory
    (:meth:`stage_out`), hands it to gloo, and copies what it receives
    back to ``device`` (:meth:`stage_in`); ``staged_bytes`` counts both
    directions and ``stage_ms`` the host time of the copies out. On the
    CPU tensors go as they are. ``bytes[kind][p]`` and ``msgs[kind][p]``
    count what this rank sent to rank p, by the transport's ``KINDS``."""

    KINDS: tuple = ()

    def __init__(self, device, world: int):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device is cuda but "
                               "torch.cuda.is_available() is False")
        self.staged = self.device.type == "cuda"
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

    @staticmethod
    def _kind(t: torch.Tensor, kind: str) -> str:
        return "scalar" if t.numel() == 1 else kind

    @staticmethod
    def _bytes_of(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(-1).view(torch.uint8)

    def send(self, t: torch.Tensor, to: int, tag: int = 0) -> None:
        """Start sending ``t`` to rank ``to``; the host copy stays alive
        until :meth:`wait_sends`."""
        t0 = self._enter()
        host = self.stage_out(t)
        work = dist.isend(self._bytes_of(host), to, tag=tag)
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
        dist.recv(self._bytes_of(host), frm, tag=tag)
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
        dist.all_gather([self._bytes_of(p) for p in parts],
                        self._bytes_of(host), group=group)
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
        dist.broadcast(self._bytes_of(host), src, group=group)
        self.stage_in(host, into=t)
        kind = self._kind(t, "p2p")
        if dist.get_rank() == src:
            self._count(kind, [p for p in members if p != src], host.nbytes)
        self._leave(kind, t0)
        return t


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
    ``sent_msgs`` per peer, ``staged_bytes``, ``wire_blocks`` (this rank's
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
            "wire_blocks": ex.wire_blocks[rank].tolist(),
            "calls": dict(ex.calls), "max_batch": dict(ex.max_batch),
            "launches": {k: after[k] - before[k] for k in after},
            "slots": slots, "row": got[0, slots].cpu()})
        del got, ex
    return out
