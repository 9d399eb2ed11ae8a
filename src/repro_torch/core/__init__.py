"""repro_torch.core — parallel DAG discovery from a PTG, its lowering to
per-wavefront index tables, and the single-device block executor (see
``discovery.py`` / ``schedule.py``)."""

from .discovery import (PTG, CommPattern, Message, ShardSchedule,
                        WavefrontSchedule, discover, discover_local,
                        segment_runs, union_pattern, union_ptg)
from .schedule import (BlockExecutor, BlockProgram, BlockPTGSpec,
                       SparseRound, build_block_program)

__all__ = [
    "BlockExecutor", "BlockProgram", "BlockPTGSpec", "CommPattern",
    "Message", "PTG", "ShardSchedule", "SparseRound", "WavefrontSchedule",
    "build_block_program", "discover", "discover_local", "segment_runs",
    "union_pattern", "union_ptg",
]
