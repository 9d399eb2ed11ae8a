"""Seconds from the process's start to the first timed step: imports,
loading the kernels, the program's build, the inputs, a world's start and
the warm-up (host clock)."""


def read(world: dict):
    return world["setup_s"]
