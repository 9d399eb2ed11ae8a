"""repro_torch.ptg — the declarative PTG front-end.

Declare a parametrized task graph once (task types + reads/writes access
patterns + owner mapping); the builder derives ``in_deps`` / ``out_deps`` /
``operands`` / ``block_of`` / ``indegree`` / seeds with the mutual-inverse
property guaranteed by construction, and the :class:`Graph` lowers to the
block executor (``Graph.to_block_spec`` / ``Graph.to_program`` /
``Graph.executor``: parallel discovery -> wavefront schedule -> index
tables). ``Graph.derive_local`` gives each shard its own lazily derived
slice (owned tasks + halo only); ``Graph.build`` remains the eager oracle.
"""

from .graph import Graph, IndexSpace, LocalView, TaskType, checked_ptg

__all__ = ["Graph", "IndexSpace", "LocalView", "TaskType", "checked_ptg"]
