"""The least time of the window's real GEMM-type tasks (yardstick: f32
peak and HBM bandwidth, each block read once and written once) over the
device time of the operations the bodies' matmul calls launched (profiler
trace, the union of their intervals over the processes), in %. Padded
slots show as waste."""


def read(world: dict):
    dv = world["device"]
    if dv is None or dv["body_s"] <= 0:
        return None
    return 100.0 * world["least_s"] * world["n_steps"] / dv["body_s"]
