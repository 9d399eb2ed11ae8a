"""The program's real GEMM-type tasks over the task slots the bodies'
matmul was called on (the batch dimension of each call, summed over the
processes), in %: what the lowering's padding leaves of the body work."""


def read(world: dict):
    if not world["slots"]:
        return None
    return 100.0 * world["real_tasks"] * world["n_steps"] / world["slots"]
