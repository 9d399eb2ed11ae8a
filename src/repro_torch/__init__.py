"""repro_torch — TaskTorrent's block-PTG path in PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100. It keeps
``repro``'s module layout, so each module has its counterpart at the same
relative path, and imports nothing of ``repro`` nor of JAX. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

- ``repro_torch.ptg``: the declarative PTG front-end (``Graph``);
- ``repro_torch.core``: parallel discovery, the lowering to per-wavefront
  index tables and the single-device block executor;
- ``repro_torch.kernels``: hand-written Hopper kernels and their plain
  PyTorch versions (``block_gemm``);
- ``repro_torch.linalg``: distributed GEMM (2D/3D) and blocked Cholesky;
- ``repro_torch.taskbench``: the Task-Bench dependence-pattern sweep.
"""
