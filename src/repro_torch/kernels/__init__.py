"""Hand-written Hopper kernels of the port. Each lives in ``csrc/`` and
has a package beside it holding its wrapper (``<name>.py``), its plain
PyTorch version (``ref.py``) and the task-body forms (``ops.py``).
``_build.py`` compiles the sources with ``nvcc`` at first use."""
