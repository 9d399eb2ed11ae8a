"""Elastic training on rank processes, on the CPU (``launch.train --ranks
--elastic``): the launcher holds the elastic controller for the run and
starts one world of rank processes a mesh lifetime.

The reduced starcoder2-3b with ``--device cpu --ranks --host-devices 4
--elastic --fake-hosts 2 --lease 2 --ckpt-every 3 --steps 8 --global-batch
4 --seq 16`` (a (2, 2) mesh: 2 hosts of 2 rank processes):

- a heartbeat kill (``--kill-host H@5``, H = 1 and 0): the plan line is
  the one ``repro``'s ``ElasticController`` gives on the same beats and
  checkpoints; the lines come in the one-process launcher's order (two
  ``mesh:`` lines, of 4 and of 2 rank processes); the step-6 checkpoint is
  the run's without the kill, byte for byte; the step-7 one is a fresh
  ``--ranks --host-devices 2`` run's restored from that step 6, byte for
  byte; and its parameters are the run's without the kill within the
  survivors' rounding (bf16 compute: their (1, 2) mesh sums the data
  group otherwise) of 2 % of the learning rate, its last loss within the
  launcher's ranked-versus-logical 1e-3;
- a rank process killed by SIGKILL (``main``'s ``fault``), after step 4
  and inside step 6's checkpoint write: the parent declares its host
  failed (``declare_failed``), tears the world down at once and re-meshes
  the survivors from step 3; the run ends ``done``, its checkpoints of
  steps 6 and 7 byte for byte a fresh (1, 2) run's from the step-3
  checkpoint, with no ``step_N.tmp`` left;
- a rank that calls ``sys.exit`` fails the run: no host is declared;
- refusals before the next world starts: a global batch that the
  survivors' data axis does not divide, and a survivor set smaller than
  the model axis (``plan_remesh``'s error).
"""

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

from repro_torch.dist.ranks import RankDied
from repro_torch.launch import train as launcher
from repro_torch.train import checkpoint as ckpt

FLAGS = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
         "--ranks", "--ckpt-every", "3", "--global-batch", "4", "--seq",
         "16"]
ELASTIC = ["--host-devices", "4", "--elastic", "--fake-hosts", "2",
           "--lease", "2", "--steps", "8"]
LR = 3e-4                                   # the launcher's default


def _launch(argv, fault=None):
    """``launcher.main(FLAGS + argv)`` with its and its ranks' standard
    output caught: (the lines, the worlds or the exit message, seconds)."""
    with tempfile.TemporaryFile("w+") as out:
        saved = os.dup(1)
        os.dup2(out.fileno(), 1)          # the ranks' prints
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(out):     # the launcher's
                got = launcher.main(FLAGS + argv, fault=fault)
        except SystemExit as exc:
            got = str(exc.code)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        seconds = time.monotonic() - t0
        out.seek(0)
        return out.read().splitlines(), got, seconds


def _fresh(src, step, steps, dest):
    """A ``--ranks --host-devices 2`` run of ``steps`` steps restored from
    ``src``'s checkpoint of ``step``, alone in ``dest``."""
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dest, name))
    return _launch(["--host-devices", "2", "--steps", str(steps),
                    "--ckpt-dir", dest])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_ranks")
    out = {}

    def run(name, argv, fault=None):
        d = str(root / name)
        out[name] = (*_launch(ELASTIC + argv + ["--ckpt-dir", d], fault), d)

    run("clean", [])
    for host in (1, 0):
        run(f"kill{host}", ["--kill-host", f"{host}@5"])
    run("die-step", [], {"rank": 2, "step": 4, "at": "step"})
    run("die-save", [], {"rank": 1, "step": 6, "at": "save"})
    clean = out["clean"][3]
    for name, step, steps in (("fresh6", 6, 1), ("fresh3", 3, 4)):
        d = str(root / name)
        out[name] = (*_fresh(clean, step, steps, d), d)
    return out


def _reference_plan(host: int) -> str:
    """The plan line ``repro``'s controller gives on the run's beats: every
    alive host beats each step but ``host`` from step 5, the poll sees the
    latest checkpoint on the cadence of 3."""
    from repro.train.elastic import ElasticController

    c = ElasticController(n_hosts=2, chips_per_host=2, model_axis=2,
                          dead_after=2.0)
    for step in range(8):
        for h in c.alive():
            if not (h == host and step >= 5):
                c.beat(h, 0.1, now=float(step))
        plan = c.poll(step // 3 * 3 or None, now=float(step))
        if plan is not None:
            return (f"host failure: survivors {plan.survivors}, re-mesh "
                    f"{plan.mesh_shape}, restore step {plan.restore_step}")
    raise AssertionError("the reference controller made no plan")


def _same_dir(a: str, b: str) -> bool:
    """Two checkpoint directories hold the same files, byte for byte."""
    names = sorted(os.listdir(os.path.join(a, "arrays")))
    if names != sorted(os.listdir(os.path.join(b, "arrays"))):
        return False
    for f in ["manifest.json"] + [os.path.join("arrays", n) for n in names]:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                return False
    return True


def _step_dir(d: str, step: int) -> str:
    return os.path.join(d, f"step_{step:08d}")


def _kept(lines):
    return [ln for ln in lines if not ln.startswith("step ")]


@pytest.mark.parametrize("host", [1, 0])
def test_heartbeat_kill_plans_and_prints_as_the_reference(runs, host):
    lines, worlds, _, _ = runs[f"kill{host}"]
    survivor = 1 - host
    plan = _reference_plan(host)
    assert plan == (f"host failure: survivors [{survivor}], re-mesh (1, 2), "
                    "restore step 6")
    kept = _kept(lines)
    assert [ln.split(" (cpu)")[0] for ln in kept] == [
        "mesh: {'data': 2, 'model': 2} on 4 rank processes", plan,
        "mesh: {'data': 1, 'model': 2} on 2 rank processes",
        "elastic restore from step 6 (resuming at step 7)", "done"], lines
    assert [w["plan"] and w["plan"].survivors for w in worlds] == [
        [survivor], None]
    # the survivors' world: rank 0 is the survivor's first chip
    assert len(worlds[1]["ranks"]) == 2
    assert all(not any(r["launches"].values()) for w in worlds
               for r in w["ranks"])
    assert worlds[0]["ranks"][0]["controller"].failed == [host]


@pytest.mark.parametrize("host", [1, 0])
def test_heartbeat_kill_checkpoints_are_the_composed_runs(runs, host):
    _, worlds, _, d = runs[f"kill{host}"]
    _, clean, _, clean_dir = runs["clean"]
    assert ckpt.latest_step(d) == 7
    assert _same_dir(_step_dir(d, 6), _step_dir(clean_dir, 6))
    assert _same_dir(_step_dir(d, 7), _step_dir(runs["fresh6"][3], 7))
    # within the survivors' rounding of the run without the kill
    for f in os.listdir(os.path.join(_step_dir(d, 7), "arrays")):
        if f.startswith("params"):
            a, b = (np.load(os.path.join(_step_dir(x, 7), "arrays", f))
                    for x in (d, clean_dir))
            assert np.abs(a - b).max() <= 0.02 * LR, f
    got = worlds[1]["ranks"][0]["steps"][7]["loss"]
    want = clean[0]["ranks"][0]["steps"][7]["loss"]
    assert abs(got - want) <= 1e-3 * want


@pytest.mark.parametrize("at,rank,host", [("step", 2, 1), ("save", 1, 0)])
def test_a_rank_that_dies_is_declared_and_the_survivors_finish(runs, at,
                                                               rank, host):
    lines, worlds, seconds, d = runs[f"die-{at}"]
    survivor = 1 - host
    assert _kept(lines) == [
        lines[0], f"rank {rank} (host {host}) died: declared failed",
        f"host failure: survivors [{survivor}], re-mesh (1, 2), restore "
        "step 3", "mesh: {'data': 1, 'model': 2} on 2 rank processes (cpu)"
        + lines[0].split("(cpu)")[1],
        "elastic restore from step 3 (resuming at step 4)", "done"], lines
    assert worlds[0]["died"] == [rank] and worlds[0]["ranks"] is None
    assert worlds[1]["died"] == [] and worlds[1]["plan"] is None
    # torn down at once: the dead world ended before the clean one would
    clean = runs["clean"][1][0]
    assert worlds[0]["t_end"] - worlds[0]["t_spawn"] \
        <= clean["t_end"] - clean["t_spawn"] + 10, seconds
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    for step in (6, 7):
        assert _same_dir(_step_dir(d, step),
                         _step_dir(runs["fresh3"][3], step)), step
    assert _same_dir(_step_dir(d, 3), _step_dir(runs["clean"][3], 3))


@pytest.mark.parametrize("argv,message", [
    (["--host-devices", "3", "--elastic", "--fake-hosts", "3",
      "--kill-host", "2@1", "--lease", "0.5", "--steps", "3",
      "--global-batch", "3"],
     "batch 3 does not split into 1 microbatches over 2 data ranks"),
    (["--host-devices", "2", "--elastic", "--fake-hosts", "1",
      "--kill-host", "0@1", "--lease", "0.5", "--steps", "3",
      "--global-batch", "2"],
     "survivor set too small: 0 chips < model axis 2")],
    ids=["batch", "survivors"])
def test_a_re_mesh_the_survivors_cannot_train_exits(tmp_path, argv,
                                                    message):
    lines, got, _ = _launch(argv + ["--ckpt-dir", str(tmp_path)])
    assert got == message, (got, lines)
    assert sum(ln.startswith("mesh:") for ln in lines) == 1, lines


def test_a_rank_that_exits_fails_the_elastic_run(tmp_path):
    """A rank that calls ``sys.exit`` is no host failure: the launcher
    fails with its message and starts no second world."""
    with pytest.raises(RuntimeError, match="rank 1 exits after step 1") \
            as err:
        _launch(ELASTIC + ["--ckpt-dir", str(tmp_path)],
                {"rank": 1, "step": 1, "at": "exit"})
    assert not isinstance(err.value, RankDied)
    assert ckpt.latest_step(str(tmp_path)) is None


def test_elastic_with_the_pipeline_on_ranks_exits_as_the_reference():
    _, got, _ = _launch(["--pipeline", "2", "--host-devices", "4",
                         "--elastic"])
    assert got == "--elastic does not compose with --pipeline yet"
