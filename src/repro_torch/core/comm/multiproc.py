"""The multi-process backend: one real OS process per rank.

The first transport that leaves the process. Each rank is a forked child
carrying the host runtime unchanged — reliable delivery, fault injection,
DEATH/epoch recovery — over length-prefixed cloudpickle frames on loopback
TCP sockets:

- **data plane**: every child runs a :class:`TcpListener`; peers connect
  lazily and stream :class:`~repro_torch.core.comm.core.Wire` frames. A send to
  a crashed peer simply fails and is dropped — exactly the lossy-channel
  model the seq/ack/retry layer was built for.
- **control plane**: one channel per child back to the parent, used for
  rendezvous (``hello``/``addr`` -> ``peers`` broadcast), membership relays
  (a self-kill becomes a ``peerdead`` broadcast so survivors fence the
  rank physically, like the in-proc world's global ``kill``), poison and
  shutdown-flag propagation, AM-fingerprint validation, forensic snapshot
  requests, and the final per-rank result.
- **service plane** (resident scheduler only): an RPC channel per child to
  the parent-hosted resident scheduler service and its
  bus; the child's ShardRuntime talks to them through
  a proxy instead of shared memory.

Bootstrap is **fork-only** by design: ``main`` and the scheduler's bound
``_rank_main`` pass to the child by address-space inheritance, never
pickled. Children must not touch fork-hostile state the parent initialized:
CUDA does not survive a fork once the parent has initialised it, so this
transport carries **host payloads only** (numpy arrays and CPU tensors; a
CUDA tensor handed to an AM raises ``ValueError`` in
:mod:`repro_torch.core.messages`, and ``run_host`` refuses a CUDA store up
front). Each child runs torch with one intra-op thread, so a CPU body never
enters an OpenMP pool inherited from the parent. Use numpy task bodies
(``cholesky_bodies_numpy``) for cross-process runs. Children exit with
``os._exit`` after reporting, so no atexit/teardown of inherited state runs
twice.

``cloudpickle`` is imported where a frame is written or read, never when
this module is imported: the runtime imports without it, and only a
cross-process run needs it.
"""

from __future__ import annotations

import heapq
import itertools
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

from ..faults import RecoveryReport
from .core import (Backend, Comm, CommClosedError, Connector, Listener,
                   Wire)

_HDR = struct.Struct("!I")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise CommClosedError("peer closed the connection")
        buf += chunk
    return buf


class TcpComm(Comm):
    """One TCP channel carrying length-prefixed cloudpickle frames."""

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()
        self._closed = False

    def write(self, msg) -> None:
        import cloudpickle

        payload = cloudpickle.dumps(msg)
        frame = _HDR.pack(len(payload)) + payload
        try:
            with self._wlock:
                if self._closed:
                    raise CommClosedError("comm closed")
                self._sock.sendall(frame)
        except OSError as e:
            self.close()
            raise CommClosedError(f"write failed: {e}") from None

    def read(self, timeout: Optional[float] = None):
        try:
            with self._rlock:
                self._sock.settimeout(timeout)
                hdr = _recv_exact(self._sock, _HDR.size)
                # the frame header arrived: finish the body on a generous
                # clock even if the caller's poll timeout was tiny
                self._sock.settimeout(60.0)
                payload = _recv_exact(self._sock, _HDR.unpack(hdr)[0])
        except socket.timeout:
            raise TimeoutError("tcp read timed out") from None
        except CommClosedError:
            self.close()
            raise
        except OSError as e:
            self.close()
            raise CommClosedError(f"read failed: {e}") from None
        import cloudpickle

        return cloudpickle.loads(payload)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


class TcpListener(Listener):
    """Accepts loopback TCP channels; one handler thread per accept."""

    def __init__(self, handler):
        super().__init__(handler)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self.address = f"tcp://127.0.0.1:{self.port}"
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="tcp-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener socket closed under us: clean stop
            if self._stopped.is_set():
                # stop() raced our in-flight accept: never service a
                # channel after shutdown
                conn.close()
                return
            threading.Thread(target=self.handler, args=(TcpComm(conn),),
                             daemon=True).start()

    def stop(self) -> None:
        self._stopped.set()
        # close() alone does not abort a blocked accept() on Linux (the
        # in-flight syscall pins the socket, so the port keeps accepting);
        # shutdown() wakes it with an error immediately
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class TcpConnector(Connector):
    def connect(self, address: str, timeout: float = 5.0) -> Comm:
        host, port = address.rsplit("://", 1)[-1].rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError as e:
            raise CommClosedError(
                f"connect to {address} failed: {e}") from None
        sock.settimeout(None)
        return TcpComm(sock)


# ------------------------------------------------------------- child side


class _RelayEvent(threading.Event):
    """A poison event whose first local ``set()`` also tells the parent,
    which re-broadcasts it to every rank — the cross-process analogue of
    the in-proc world's single shared Event."""

    def __init__(self, notify):
        super().__init__()
        self._notify = notify

    def set(self) -> None:
        first = not self.is_set()
        super().set()
        if first:
            try:
                self._notify()
            except Exception:
                pass  # parent gone: local poison still unwinds this rank

    def set_local(self) -> None:
        super().set()


class _RpcClient:
    """Lock-serialized request/response channel to the parent-hosted
    scheduler service (see a proxy)."""

    def __init__(self, port: int):
        self._comm = TcpConnector().connect(f"tcp://127.0.0.1:{port}",
                                            timeout=10.0)
        self._lock = threading.Lock()

    def call(self, target: str, method: str, *args, **kwargs):
        with self._lock:
            self._comm.write(("call", target, method, args, kwargs))
            status, payload = self._comm.read(timeout=60.0)
        if status == "ok":
            return payload
        raise RuntimeError(
            f"rpc {target}.{method} failed in the service process:\n"
            f"{payload}")


class MultiProcWorld:
    """The world contract, implemented by one child process for its own
    rank: local delay heap for inbound wires, lazy outbound channels,
    sender-side fault injection with the same per-edge RNG streams as the
    in-proc world (deterministic parity), and membership relayed through
    the parent control channel. Payloads cross a process boundary as
    pickled frames, so they must be host data (``carries_device_tensors``
    is False)."""

    carries_device_tensors = False

    def __init__(self, rank: int, n_ranks: int, peers: Dict[int, str],
                 ctrl: TcpComm, delay_fn, faults, rpc_port: Optional[int]):
        self.rank = rank
        self.n_ranks = n_ranks
        self.delay_fn = delay_fn
        self.faults = faults
        self.report = RecoveryReport()
        self.dead: set = set()
        self.poison = _RelayEvent(self._relay_poison)
        self._peers = peers
        self._ctrl = ctrl
        self._listener: Optional[TcpListener] = None
        self._lock = threading.Lock()
        self._inbox: list = []
        self._order = itertools.count()
        self._conns: Dict[int, TcpComm] = {}
        self._conn_lock = threading.Lock()
        self._fault_lock = threading.Lock()
        self._user_sent = 0
        self._edge_rng: Dict[tuple, Any] = {}
        self._shutdown_flags = [False] * n_ranks
        self._fps: List[str] = []
        self._snapshot_fn = None
        self.svc_rpc = _RpcClient(rpc_port) if rpc_port is not None else None

    # --------------------------------------------------------- control plane

    def _ctrl_send(self, msg: tuple) -> None:
        try:
            self._ctrl.write(msg)
        except CommClosedError:
            # parent died: nothing to relay to; poison locally so this
            # rank unwinds instead of spinning in the protocol forever
            self.poison.set_local()

    def _relay_poison(self) -> None:
        self._ctrl_send(("poison",))

    def _handle_ctrl(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "peerdead":
            self.kill(msg[1])
        elif kind == "poison":
            self.poison.set_local()   # relay, not origin: don't echo back
        elif kind == "sdflag":
            self._shutdown_flags[msg[1]] = True
        elif kind == "snap?":
            self._ctrl_send(("snap", self.rank,
                             self.snapshot_rank(self.rank)))

    def _ctrl_loop(self) -> None:
        while True:
            try:
                msg = self._ctrl.read()
            except (CommClosedError, TimeoutError, Exception):
                self.poison.set_local()
                return
            self._handle_ctrl(msg)

    # ----------------------------------------------------------- fault hooks

    def check_dead_or_kill(self, src: int) -> bool:
        if src in self.dead:
            return True
        f = self.faults
        if f is None or src != self.rank or src not in f.kill:
            return False
        with self._fault_lock:
            self._user_sent += 1
            fire = self._user_sent >= f.kill[src] and src not in self.dead
        if fire:
            self.kill(src)
        return src in self.dead

    def kill(self, rank: int) -> None:
        """Local fence for ``rank`` (purge its inbound frames, flag its
        shutdown). Killing *this* rank additionally tells the parent,
        which broadcasts ``peerdead`` so every survivor fences it too —
        the cross-process version of the in-proc global kill."""
        with self._fault_lock:
            if rank in self.dead:
                return
            self.dead.add(rank)
        self._shutdown_flags[rank] = True
        with self._lock:
            if rank == self.rank:
                self._inbox.clear()
            else:
                kept = [item for item in self._inbox
                        if item[2].src != rank]
                if len(kept) != len(self._inbox):
                    heapq.heapify(kept)
                    self._inbox = kept
        if rank == self.rank:
            self._ctrl_send(("ikilled", rank))
            if self._listener is not None:
                self._listener.stop()
            with self._conn_lock:
                conns, self._conns = dict(self._conns), {}
            for c in conns.values():
                c.close()

    def flag_shutdown(self, rank: int) -> None:
        self._shutdown_flags[rank] = True
        if rank == self.rank:
            self._ctrl_send(("sdflag", rank))

    def all_shutdown(self) -> bool:
        return all(self._shutdown_flags)

    # ------------------------------------------------------------- transport

    def send(self, dst: int, wire: Wire) -> None:
        if wire.src in self.dead or dst in self.dead:
            return
        duplicate = False
        f = self.faults
        if f is not None and (f.drop or f.duplicate):
            with self._fault_lock:
                rng = self._edge_rng.get((wire.src, dst))
                if rng is None:
                    rng = self._edge_rng[(wire.src, dst)] = f.edge_rng(
                        wire.src, dst)
                dropped = rng.random() < f.drop
                duplicate = rng.random() < f.duplicate
            if dropped:
                self.report.bump("injected_drops")
                return
            if duplicate:
                self.report.bump("injected_dups")
        self._post(dst, wire)
        if duplicate:
            self._post(dst, wire)

    def _post(self, dst: int, wire: Wire) -> None:
        if dst == self.rank:
            self._ingest(wire)
            return
        try:
            self._conn(dst).write(wire)
        except CommClosedError:
            # crashed/closed peer: a dropped frame, the reliable layer's
            # retransmit owns recovery. Forget the conn so the next send
            # redials (the peer may just not be accepting *yet*).
            with self._conn_lock:
                self._conns.pop(dst, None)

    def _conn(self, dst: int) -> TcpComm:
        with self._conn_lock:
            c = self._conns.get(dst)
            if c is None or c.closed:
                c = self._conns[dst] = TcpConnector().connect(
                    self._peers[dst], timeout=5.0)
            return c

    def _ingest(self, wire: Wire) -> None:
        if wire.src in self.dead:
            return  # fenced: frames from a declared-dead rank never land
        delay = self.delay_fn(wire.src, self.rank, wire.kind) \
            if self.delay_fn else 0.0
        with self._lock:
            heapq.heappush(self._inbox, (time.monotonic() + delay,
                                         next(self._order), wire))

    def poll(self, rank: int) -> List[Wire]:
        now = time.monotonic()
        out: List[Wire] = []
        with self._lock:
            while self._inbox and self._inbox[0][0] <= now:
                wire = heapq.heappop(self._inbox)[2]
                if wire.src not in self.dead:
                    out.append(wire)
        return out

    def has_traffic(self, rank: int) -> bool:
        with self._lock:
            return bool(self._inbox)

    def register_fingerprint(self, rank: int, fp: str) -> int:
        """Registration order is per-rank deterministic, so the id is
        assigned locally; the parent cross-validates all ranks' orders
        and poisons the world on divergence (§II-B2, like in-proc)."""
        am_id = len(self._fps)
        self._fps.append(fp)
        self._ctrl_send(("reg", rank, am_id, fp))
        return am_id

    # ------------------------------------------------------------- forensics

    def attach_snapshot_provider(self, rank: int, fn) -> None:
        self._snapshot_fn = fn

    def snapshot_rank(self, rank: int):
        fn = self._snapshot_fn
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:
            return f"<snapshot failed: {e!r}>"


def _scrub_inherited_import_state() -> None:
    """Make the forked child's import machinery usable again.

    The parent may fork from a background thread (the scheduler service
    forks resident ranks from its drive thread) while *another* parent
    thread is mid-way through a lazy import — e.g. ``scipy.linalg`` inside
    ``cholesky_bodies_numpy``.  CPython resets the global import lock at
    fork but keeps the per-module ``_ModuleLock`` instances, so the child
    inherits locks owned by threads that do not exist here: the first
    unpickle that re-imports such a module (cloudpickle ``subimport``)
    blocks forever.  Drop half-initialized modules and every per-module
    lock; the child re-imports them cleanly on demand.
    """
    import importlib._bootstrap as _boot
    import sys
    initializing = [
        name for name, mod in sys.modules.items()
        if getattr(getattr(mod, "__spec__", None), "_initializing", False)
    ]
    popped = set(initializing)
    # an aborted package import leaves *completed* submodules behind
    # (e.g. ``scipy.linalg.blas`` inside a half-imported ``scipy.linalg``);
    # a re-import of the parent then finds them cached and never rebinds them as
    # attributes on the fresh parent module — drop the whole subtree so
    # the re-import is fully fresh
    prefixes = tuple(n + "." for n in initializing)
    if prefixes:
        popped.update(n for n in sys.modules if n.startswith(prefixes))
    for name in popped:
        sys.modules.pop(name, None)
    if popped and os.environ.get("REPRO_MP_DEBUG"):
        print(f"[multiproc child] scrubbed {sorted(popped)}",
              file=sys.stderr, flush=True)
    _boot._module_locks.clear()


def _child_entry(rank: int, n_ranks: int, main, n_threads: int,
                 delay_fn, faults, ctrl_port: int,
                 rpc_port: Optional[int]) -> None:
    """Whole life of one rank process. Always exits via ``os._exit`` so no
    parent-inherited teardown (atexit hooks, CUDA state) runs here."""
    ctrl = None
    try:
        _scrub_inherited_import_state()
        # an OpenMP pool inherited from the parent can hang the child's
        # first parallel region: run torch's CPU ops on this thread only
        import torch
        torch.set_num_threads(1)
        # debug aid: SIGUSR1 dumps every thread's stack to stderr, so a
        # wedged rank can be diagnosed from outside without a debugger
        import faulthandler
        import signal
        faulthandler.register(signal.SIGUSR1, all_threads=True)
        ctrl = TcpConnector().connect(f"tcp://127.0.0.1:{ctrl_port}",
                                      timeout=10.0)
        ctrl.write(("hello", rank))
        ready = threading.Event()
        cell: dict = {}

        def on_data(comm: Comm) -> None:
            ready.wait()
            world = cell["world"]
            while True:
                try:
                    wire = comm.read()
                except (CommClosedError, TimeoutError):
                    return
                world._ingest(wire)

        listener = TcpListener(on_data)
        listener.start()
        ctrl.write(("addr", rank, listener.address))
        # rendezvous: async relays (a sibling may already be failing) can
        # arrive before the peer map — buffer them for the world
        peers, early = None, []
        while peers is None:
            msg = ctrl.read(timeout=30.0)
            if msg[0] == "peers":
                peers = msg[1]
            else:
                early.append(msg)
        world = MultiProcWorld(rank, n_ranks, peers, ctrl, delay_fn,
                               faults, rpc_port)
        world._listener = listener
        cell["world"] = world
        ready.set()
        for msg in early:
            world._handle_ctrl(msg)
        threading.Thread(target=world._ctrl_loop, daemon=True,
                         name="ctrl").start()

        from .. import runtime as rt  # cached import: parent loaded it

        status, payload = rt.rank_session(world, rank, main, n_threads)
        if status == "error":
            payload = rt.format_rank_error(payload)
        try:
            ctrl.write(("result", rank, status, payload, world.report))
        except Exception as e:
            try:
                ctrl.write(("result", rank, "error",
                            f"rank {rank} result not picklable "
                            f"({type(payload).__name__}: {e!r})", None))
            except Exception:
                pass
    except BaseException:
        import sys
        import traceback
        tb = traceback.format_exc()
        print(f"[multiproc rank {rank}] {tb}", file=sys.stderr, flush=True)
        if ctrl is not None:
            try:
                ctrl.write(("result", rank, "error", tb, None))
            except Exception:
                pass
    finally:
        os._exit(0)


# ------------------------------------------------------------ parent side


class _RpcServer:
    """Parent-hosted dispatch onto the resident scheduler: children call
    ``svc``/``bus`` methods by name; exceptions travel back formatted."""

    def __init__(self, objs: Dict[str, object]):
        self._objs = objs
        self._listener = TcpListener(self._serve)
        self._listener.start()
        self.port = self._listener.port

    def _serve(self, comm: Comm) -> None:
        import traceback
        while True:
            try:
                _, target, method, args, kwargs = comm.read()
            except (CommClosedError, TimeoutError):
                return
            try:
                out = ("ok", getattr(self._objs[target], method)(
                    *args, **kwargs))
            except BaseException:
                out = ("err", traceback.format_exc())
            try:
                comm.write(out)
            except CommClosedError:
                return

    def stop(self) -> None:
        self._listener.stop()


class _ParentWorld:
    """What the resident scheduler sees as "the world" in the parent
    process: fault plan, membership mirror, poison mirror, and forensic
    snapshots served by the rank processes over their control channels."""

    def __init__(self, n_ranks: int, faults, state: "_ParentState"):
        self.n_ranks = n_ranks
        self.faults = faults
        self.report = RecoveryReport()
        self.poison = threading.Event()
        self.dead: set = set()
        self._state = state

    def attach_snapshot_provider(self, rank: int, fn) -> None:
        pass  # ranks live elsewhere; their processes serve snapshots

    def snapshot_rank(self, rank: int):
        return self._state.request_snapshot(rank)


class _ParentState:
    """Rendezvous + relay hub: one handler thread per child control
    channel (spawned by the listener), shared collection state here."""

    def __init__(self, n_ranks: int, faults):
        self.n_ranks = n_ranks
        self.lock = threading.Lock()
        self.comms: Dict[int, TcpComm] = {}
        self.addrs: Dict[int, str] = {}
        self.results: Dict[int, tuple] = {}   # rank -> (status, payload)
        self.reports: Dict[int, Optional[RecoveryReport]] = {}
        self.errors: List[tuple] = []         # (rank, formatted traceback)
        self.snaps: Dict[int, object] = {}
        self.all_addrs = threading.Event()
        self.all_results = threading.Event()
        self.snap_ev = threading.Event()
        self._fps: Dict[int, List[str]] = {}
        self.world = _ParentWorld(n_ranks, faults, self)

    # ---- broadcast & per-child serving

    def broadcast(self, msg: tuple) -> None:
        with self.lock:
            comms = list(self.comms.values())
        for c in comms:
            try:
                c.write(msg)
            except CommClosedError:
                pass  # that child is gone; its EOF path reports it

    def serve_child(self, comm: Comm) -> None:
        rank = None
        try:
            while True:
                msg = comm.read()
                kind = msg[0]
                if kind == "hello":
                    rank = msg[1]
                    with self.lock:
                        self.comms[rank] = comm
                elif kind == "addr":
                    with self.lock:
                        self.addrs[msg[1]] = msg[2]
                        if len(self.addrs) == self.n_ranks:
                            self.all_addrs.set()
                elif kind == "ikilled":
                    with self.lock:
                        self.world.dead.add(msg[1])
                    self.broadcast(("peerdead", msg[1]))
                elif kind == "poison":
                    self.world.poison.set()
                    self.broadcast(("poison",))
                elif kind == "sdflag":
                    self.broadcast(("sdflag", msg[1]))
                elif kind == "reg":
                    self._validate_fp(*msg[1:])
                elif kind == "snap":
                    with self.lock:
                        self.snaps[msg[1]] = msg[2]
                    self.snap_ev.set()
                elif kind == "result":
                    _, r, status, payload, report = msg
                    with self.lock:
                        self.results[r] = (status, payload)
                        self.reports[r] = report
                        if status == "error":
                            self.errors.append((r, payload))
                            self.world.poison.set()
                        if len(self.results) == self.n_ranks:
                            self.all_results.set()
                    return
        except (CommClosedError, TimeoutError):
            with self.lock:
                if rank is not None and rank not in self.results:
                    # died without reporting: a hard crash, not a planned
                    # kill (killed ranks still report "killed")
                    self.results[rank] = ("error", None)
                    self.errors.append((rank, (
                        f"rank {rank} process died without reporting "
                        "(control channel EOF)")))
                    self.world.poison.set()
                    if len(self.results) == self.n_ranks:
                        self.all_results.set()
            if rank is not None:
                self.broadcast(("poison",))

    def _validate_fp(self, rank: int, am_id: int, fp: str) -> None:
        with self.lock:
            self._fps.setdefault(rank, []).append(fp)
            for other, fps in self._fps.items():
                if other != rank and len(fps) > am_id \
                        and fps[am_id] != fp:
                    self.errors.append((rank, (
                        f"active messages registered in different orders: "
                        f"rank {rank} registered {fp!r} as id {am_id}, "
                        f"rank {other} has {fps[am_id]!r}")))
                    self.world.poison.set()
                    break
            else:
                return
        self.broadcast(("poison",))

    def request_snapshot(self, rank: int, timeout: float = 2.0):
        with self.lock:
            self.snaps.pop(rank, None)
            comm = self.comms.get(rank)
        if comm is None:
            return None
        self.snap_ev.clear()
        try:
            comm.write(("snap?",))
        except CommClosedError:
            return None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.snap_ev.wait(timeout=0.05)
            with self.lock:
                if rank in self.snaps:
                    return self.snaps[rank]
        return None


def _merge_report(base: RecoveryReport,
                  parts: List[Optional[RecoveryReport]]) -> RecoveryReport:
    for rep in parts:
        if rep is None:
            continue
        for c in RecoveryReport._COUNTERS:
            setattr(base, c, getattr(base, c) + getattr(rep, c))
        for s in rep.suspects:
            if s not in base.suspects:
                base.suspects.append(s)
        for d in rep.deaths:
            if d not in base.deaths:
                base.deaths.append(d)
        for sh in rep.rederived_shards:
            if sh not in base.rederived_shards:
                base.rederived_shards.append(sh)
        if rep.total_edges is not None and base.total_edges is None:
            base.total_edges = rep.total_edges
        if rep.recovery_seconds is not None:
            base.recovery_seconds = max(base.recovery_seconds or 0.0,
                                        rep.recovery_seconds)
    return base


class MultiProcBackend(Backend):
    """Fork one process per rank; rendezvous, relay, and collect."""

    carries_device_tensors = False

    def listener(self, handler) -> Listener:
        return TcpListener(handler)

    def connector(self) -> Connector:
        return TcpConnector()

    def run_ranks(self, n_ranks: int, main, *, n_threads: int = 2,
                  delay_fn=None, faults=None, timeout: float = 120.0,
                  serve_scheduler=None):
        import multiprocessing

        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError(
                "the multiproc transport needs the fork start method "
                "(main/_rank_main pass to children by inheritance); "
                "this platform has none")
        mp = multiprocessing.get_context("fork")
        state = _ParentState(n_ranks, faults)
        ctrl = TcpListener(state.serve_child)
        ctrl.start()
        rpc = None
        if serve_scheduler is not None:
            rpc = _RpcServer({"svc": serve_scheduler,
                              "bus": serve_scheduler.bus})
            serve_scheduler.attach_world(state.world)
        procs = []
        try:
            procs = [
                mp.Process(
                    target=_child_entry,
                    args=(r, n_ranks, main, n_threads, delay_fn, faults,
                          ctrl.port, rpc.port if rpc else None),
                    daemon=True, name=f"rank{r}")
                for r in range(n_ranks)
            ]
            for p in procs:
                p.start()
            if not state.all_addrs.wait(timeout=30.0):
                missing = [r for r in range(n_ranks)
                           if r not in state.addrs]
                raise RuntimeError(
                    f"multiproc rendezvous failed: no address from ranks "
                    f"{missing} within 30s")
            state.broadcast(("peers", dict(state.addrs)))
            if serve_scheduler is not None:
                while not serve_scheduler.draining.wait(timeout=0.25):
                    if state.world.poison.is_set() or state.errors:
                        break
            if not state.all_results.wait(timeout=timeout):
                with state.lock:
                    stuck = [r for r in range(n_ranks)
                             if r not in state.results]
                from .. import runtime as rt
                forensics = rt.timeout_forensics(stuck, state.world,
                                                 timeout)
                state.world.poison.set()
                state.broadcast(("poison",))
                raise TimeoutError(forensics)
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
            ctrl.stop()
            if rpc is not None:
                rpc.stop()
        with state.lock:
            errors = list(state.errors)
            results = [state.results.get(r, ("error", None))[1]
                       if state.results.get(r, ("", None))[0] == "ok"
                       else None for r in range(n_ranks)]
            reports = [state.reports.get(r) for r in range(n_ranks)]
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} failed:\n{tb}")
        _merge_report(state.world.report, reports)
        if faults is not None:
            return results, state.world.report
        return results
