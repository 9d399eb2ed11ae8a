"""Host seconds of the program's build (the PTG declared, derived per
shard, discovered and lowered), timed around the application's ``build``;
in a world, the slowest rank's."""


def read(world: dict):
    return world["build_s"]
