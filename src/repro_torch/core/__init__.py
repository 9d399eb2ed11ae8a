"""repro_torch.core — TaskTorrent: PTG task runtime + one-sided active
messages, and the compiled block path.

Host-dynamic layer (faithful to the paper; the port's copies of the JAX
package's ``repro.core`` runtime, with tensor payloads kept on their
device): Threadpool, Taskflow, Communicator/ActiveMsg/view,
CompletionDetector, run_ranks (SPMD rank emulation), STFGraph (StarPU-style
baseline), FaultPlan/RecoveryReport, and the pluggable transports
(``comm``: ``inproc``, ``multiproc``).

Compiled layer: parallel DAG discovery from a PTG, its lowering to
per-wavefront index tables and the single-device block executor (see
``discovery.py`` / ``schedule.py``).
"""

from .comm import backend_names, get_backend, register_backend
from .completion import CompletionDetector
from .discovery import (PTG, CommPattern, Message, ShardSchedule,
                        WavefrontSchedule, discover, discover_local,
                        segment_runs, union_pattern, union_ptg)
from .faults import FaultPlan, RecoveryReport
from .messages import (ActiveMsg, Communicator, InProcWorld, RankKilled,
                       WorldPoisoned, payload_stats, view)
from .runtime import RankContext, run_ranks
from .schedule import (BlockExecutor, BlockProgram, BlockPTGSpec,
                       SparseRound, build_block_program)
from .stf import READ, READWRITE, STFGraph, WRITE
from .taskflow import Taskflow
from .threadpool import Task, Threadpool

__all__ = [
    "ActiveMsg", "BlockExecutor", "BlockProgram", "BlockPTGSpec",
    "CommPattern", "Communicator", "CompletionDetector", "FaultPlan",
    "InProcWorld", "Message", "PTG", "RankContext", "RankKilled", "READ",
    "READWRITE", "RecoveryReport", "STFGraph", "ShardSchedule",
    "SparseRound", "Task", "Taskflow", "Threadpool", "WavefrontSchedule",
    "WorldPoisoned", "WRITE", "backend_names", "build_block_program",
    "discover", "discover_local", "get_backend", "payload_stats",
    "register_backend", "run_ranks", "segment_runs", "union_pattern",
    "union_ptg", "view",
]
