"""The window's useful operations (the application's count a step) over
its time and the card's f32 peak, in %."""

from portbench.yardstick import PEAK_F32_FLOPS


def read(world: dict):
    return (100.0 * world["flops"] * world["n_steps"] / world["window_s"]
            / PEAK_F32_FLOPS)
