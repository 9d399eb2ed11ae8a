"""The 95th percentile of the window's step times, in ms (host clock),
each step from its start to its drained end; in a world, the slowest
rank's time of each step."""

from portbench.yardstick import p95


def read(world: dict):
    return 1e3 * p95(world["steps_s"])
