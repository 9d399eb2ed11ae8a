"""repro_torch.dist — the sharding substrate binding models to a mesh.

The port of ``repro.dist``. Architecture (PTG → discovery →
WavefrontSchedule → exchange plan): an application describes its work as a
parametrized task graph (``core.discovery.PTG``); ``discover()`` expands
the DAG shard-locally and levels it into a ``WavefrontSchedule``, whose
``comm_plan(w)`` batches every cross-shard edge of wavefront *w* into one
fused buffer per (src, dst) pair. This package binds those schedules (and
ordinary model code) to a mesh — a logical one on the port's one device
(``launch/mesh.py``):

- :mod:`repro_torch.dist.ctx` — ambient mesh/sharding context. Model code
  stays mesh-agnostic and only calls ``annotate(x, spec)``: the identity,
  with or without a mesh, since a logical mesh has nothing to move.
  Launchers set the batch axes and sequence-sharding policy once;
  ``act_spec()``/``data_rows()`` derive the rest.
- :mod:`repro_torch.dist.sharding` — tree-path-driven spec derivation:
  ``param_specs`` walks the abstract parameter tree (on the meta device)
  and assigns tensor-parallel ``PartitionSpec``s by leaf name,
  ``cache_specs`` shards decode caches (KV-head sharding with a
  sequence-dim fallback), ``sanitize_spec``/``sanitize_specs`` drop mesh
  axes a concrete shape cannot divide (rightmost-first inside tuple
  entries), and ``named_shardings`` gives each leaf's DTensor placements.
- :mod:`repro_torch.dist.pipeline` — stage-parallel execution lowered from
  the *same* discovery layer: the GPipe-style pipeline PTG is leveled by
  ``discover`` and each wavefront's cross-stage hand-offs are exactly the
  ``comm_plan`` pairs. On one device the pipeline runs the schedule's live
  tasks in wavefront order and hands each output on through the
  wavefront's permutation; on a mesh of ranks (``Mesh(..., group=)``)
  each rank runs its own stage's tasks and each hand-off is a send to the
  pair the permutation names.
- :mod:`repro_torch.dist.ranks` — the block executor on real ranks: one
  spawned process per shard in a ``torch.distributed`` group
  (``spawn_ranks``), each running its own shard
  (``BlockProgram.executor(..., group=)``), the exchanges copies between
  the ranks' device mailboxes (``DeviceTransport``; or gloo collectives
  staged through host memory, ``HostTransport``); and the model path's
  tensors between the ranks of a mesh (``DeviceTensorTransport`` or
  ``TensorTransport``: sends, f32 all-reduces, all-gathers,
  broadcasts).
"""
