"""The port's pipeline (``dist/pipeline.py``) and pipelined training
against the JAX package's, on the CPU.

- the pipeline PTG's tables for several (stages, microbatches): derived
  edges, per-stage wavefronts, comm patterns, ``halo_split``, the
  permutation rounds and ``schedule_depth`` equal ``repro``'s exactly;
- ``pipeline_apply`` and ``pipeline_loss_fn`` against ``repro``'s on 4
  forced host devices (an Auto-axis ``jax.sharding.Mesh``), run once in a
  subprocess that writes an ``.npz``, with the shapes of
  ``tests/multi_device_cases.py::case_pipeline_matches_sequential`` (4
  stages, 8 microbatches of 4 x 16, ``tanh(x @ p)``) from numpy inputs:
  outputs to 1e-5, gradients to rtol 1e-4 / atol 1e-5, the case's own
  bounds; and bit for bit the stages applied microbatch by microbatch,
  with one ``stage_fn`` call per (stage, microbatch) and one wavefront a
  step of the schedule;
- ``make_pipeline_train_step`` on the reduced starcoder2-3b (4 layers, 2
  stages, 4 microbatches, f32): its loss to 1e-6 relative and its
  gradients to 1e-5 of each leaf's max|g| against the port's sequential
  ``loss_and_grads``; one step's parameters against the sequential
  step's; its loss to 1e-5 against ``repro``'s ``lm_loss`` on the same
  (converted) weights; the loss falls over steps; a non-dense family and
  unequal stages raise;
- the launchers in a subprocess: ``launch.train --pipeline 2 --reduced
  --device cpu`` (the loss falls) and ``launch.serve --host-devices 4
  --reduced --device cpu`` on an MoE arch.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import get_config as jx_get_config
from repro.dist import pipeline as jx_pipe
from repro.models import transformer as jx_tfm

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.dist import pipeline as pipe
from repro_torch.launch.mesh import Mesh, make_pipeline_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.train.data import SyntheticLM
from repro_torch.train.train_step import (init_train_state, loss_and_grads,
                                          make_pipeline_loss,
                                          make_pipeline_train_step,
                                          make_train_step, value_and_grads)
from repro_torch.train.tree import leaf_paths, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [(1, 1), (1, 3), (2, 1), (2, 4), (3, 5), (4, 6), (4, 8), (5, 2)]
N_STAGES, N_MICRO, MB, D = 4, 8, 4, 16


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("stages,micro", PAIRS,
                         ids=[f"{s}x{m}" for s, m in PAIRS])
def test_pipeline_tables_match_reference(stages, micro):
    want = jx_pipe.pipeline_schedule(stages, micro)
    got = pipe.pipeline_schedule(stages, micro)
    assert pipe.schedule_depth(stages, micro) \
        == jx_pipe.schedule_depth(stages, micro) == stages + micro - 1
    assert got.n_wavefronts == want.n_wavefronts
    assert [s.wavefronts for s in got.shards] \
        == [s.wavefronts for s in want.shards]
    assert got.level_of == want.level_of
    j_ptg, p_ptg = (jx_pipe.pipeline_ptg(stages, micro),
                    pipe.pipeline_ptg(stages, micro))
    for key in want.level_of:
        assert list(p_ptg.in_deps(key)) == list(j_ptg.in_deps(key)), key
        assert list(p_ptg.out_deps(key)) == list(j_ptg.out_deps(key)), key
        assert p_ptg.mapping(key) == j_ptg.mapping(key)
    for w in range(want.n_wavefronts):
        assert got.comm_pattern(w).pair_counts \
            == want.comm_pattern(w).pair_counts
        assert got.comm_pairs(w) == want.comm_pairs(w)
        assert got.halo_split(w) == want.halo_split(w)
    assert pipe._stage_perms(got) == jx_pipe._stage_perms(want)


def test_split_microbatches():
    x = torch.arange(24).reshape(6, 4)
    got = pipe.split_microbatches({"a": x, "b": {"c": x[:, 0]}}, 3)
    assert got["a"].shape == (3, 2, 4) and got["b"]["c"].shape == (3, 2)
    assert torch.equal(got["a"].reshape(6, 4), x)
    with pytest.raises(ValueError, match="not divisible"):
        pipe.split_microbatches(x, 4)


# --------------------------------------------- pipeline_apply vs repro

def _inputs():
    rng = np.random.default_rng(0)
    params = (rng.standard_normal((N_STAGES, D, D)) * D ** -0.5).astype(
        np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    ys = rng.standard_normal((N_MICRO * MB, D)).astype(np.float32)
    return params, xs, ys


def _write_reference(path):
    """``repro``'s pipeline_apply and the gradient of its
    pipeline_loss_fn, on 4 host devices."""
    params, xs, batch_y = _inputs()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N_STAGES]), ("pipe",))

    def stage_fn(p, x):
        return jnp.tanh(x @ p)

    loss = jx_pipe.pipeline_loss_fn(
        stage_fn, lambda yh, y: jnp.mean((yh - y) ** 2), mesh=mesh,
        n_micro=N_MICRO)
    with mesh:
        ys = jx_pipe.pipeline_apply(stage_fn, jnp.asarray(params),
                                    jnp.asarray(xs), mesh=mesh)
        grads = jax.grad(loss)(jnp.asarray(params),
                               jnp.asarray(xs.reshape(N_MICRO * MB, D)),
                               jnp.asarray(batch_y))
    np.savez(path, ys=np.asarray(ys), grads=np.asarray(grads))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_pipeline") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _stage(p, x):
    return torch.tanh(x @ p)


def test_pipeline_apply_matches_reference(reference):
    params, xs, _ = map(torch.from_numpy, _inputs())
    mesh = Mesh((N_STAGES,), ("pipe",), "cpu")
    pipe.pipeline_apply.stage_calls = pipe.pipeline_apply.wavefronts = 0
    ys = pipe.pipeline_apply(_stage, params, xs, mesh=mesh)
    assert pipe.pipeline_apply.stage_calls == N_STAGES * N_MICRO
    assert pipe.pipeline_apply.wavefronts == N_STAGES + N_MICRO - 1
    np.testing.assert_allclose(ys.numpy(), reference["ys"], rtol=1e-5,
                               atol=1e-5)
    want = []
    for m in range(N_MICRO):          # the stages, microbatch by microbatch
        h = xs[m]
        for s in range(N_STAGES):
            h = _stage(params[s], h)
        want.append(h)
    assert torch.equal(ys, torch.stack(want))
    # a list of per-stage trees is the same as the stacked leaves, and
    # ``scan_runs`` (the reference's signature) folds nothing
    assert torch.equal(pipe.pipeline_apply(_stage, list(params), xs,
                                           mesh=mesh), ys)
    assert torch.equal(pipe.pipeline_apply(_stage, params, xs, mesh=mesh,
                                           scan_runs=False), ys)


def test_pipeline_loss_grads_match_reference(reference):
    params, xs, batch_y = map(torch.from_numpy, _inputs())
    mesh = Mesh((N_STAGES,), ("pipe",), "cpu")
    loss = pipe.pipeline_loss_fn(
        _stage, lambda yh, y: torch.mean((yh - y) ** 2), mesh=mesh,
        n_micro=N_MICRO)
    p = params.clone().requires_grad_()
    loss(p, xs.reshape(N_MICRO * MB, D), batch_y).backward()
    np.testing.assert_allclose(p.grad.numpy(), reference["grads"],
                               rtol=1e-4, atol=1e-5)


def test_pipeline_refuses_a_stage_count_off_the_mesh():
    params, xs, _ = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="stages"):
        pipe.pipeline_apply(_stage, params[:3], xs,
                            mesh=Mesh((N_STAGES,), ("pipe",), "cpu"))


# ---------------------------------------------------- pipelined training

def _cfgs(**kw):
    kw = {"n_layers": 4, "vocab_size": 128, "compute_dtype": "float32",
          **kw}
    return (jx_base.reduced(jx_get_config("starcoder2-3b"), **kw),
            pt_base.reduced(get_config("starcoder2-3b"), **kw))


def _batch(cfg, step=0):
    ds = SyntheticLM(cfg.vocab_size, 32, 8, learnable=True, seed=3)
    b = ds.batch_at(step)
    b["labels"][0, ::5] = -1
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_pipelined_loss_and_grads_match_sequential():
    _, cfg = _cfgs()
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    batch = _torch(_batch(cfg))
    want_loss, want = loss_and_grads(cfg, params, batch)
    pipe.pipeline_apply.stage_calls = 0
    loss, got = value_and_grads(make_pipeline_loss(cfg, mesh, n_micro=4),
                                params, batch)
    assert pipe.pipeline_apply.stage_calls == 2 * 4
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(
        float(want_loss))
    for (name, g), (_, w) in zip(leaf_paths(got), leaf_paths(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        assert err <= 1e-5, (name, err)


def test_pipelined_step_matches_sequential_step():
    _, cfg = _cfgs()
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    batch = _torch(_batch(cfg))
    p1, o1 = init_train_state(cfg, seed=0, device="cpu")
    p2, o2 = init_train_state(cfg, seed=0, device="cpu")
    p1, o1, m1 = make_train_step(cfg, lr=1e-3)(p1, o1, batch)
    p2, o2, m2 = make_pipeline_train_step(cfg, mesh, lr=1e-3, n_micro=4)(
        p2, o2, batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6 * float(
        m1["loss"])
    assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 \
        * float(m1["grad_norm"])
    assert int(o1.step) == int(o2.step) == 1
    for (name, a), (_, b) in zip(leaf_paths(p2), leaf_paths(p1)):
        # AdamW's first step moves each weight by about lr: a gradient
        # difference of 1e-5 of its leaf's max may flip only weights whose
        # gradient is within that of zero
        assert float((a - b).abs().max()) <= 2e-3 + 1e-6, name


def test_pipelined_loss_matches_reference_lm_loss():
    jcfg, pcfg = _cfgs()
    jp = jx_tfm.init_params(jcfg, jax.random.key(0))
    b = _batch(pcfg)
    want = float(jx_tfm.lm_loss(jcfg, jp, {k: jnp.asarray(v)
                                           for k, v in b.items()}))
    params = params_from_reference(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    with torch.no_grad():
        got = float(make_pipeline_loss(pcfg, mesh, n_micro=4)(
            params, _torch(b)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_pipelined_training_lowers_the_loss():
    _, cfg = _cfgs(compute_dtype="bfloat16")
    mesh = make_pipeline_mesh(2, 4, device="cpu")
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    step = make_pipeline_train_step(cfg, mesh, lr=2e-3, n_micro=4)
    losses = []
    for s in range(12):
        params, opt, m = step(params, opt, _torch(_batch(cfg, s)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_pipelined_step_refuses_what_it_cannot_split():
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    for arch in ("deepseek-v3-671b", "mamba2-1.3b", "seamless-m4t-large-v2"):
        with pytest.raises(ValueError, match="dense family"):
            make_pipeline_train_step(pt_base.reduced(get_config(arch)), mesh,
                                     n_micro=4)
    _, cfg = _cfgs(n_layers=3)
    with pytest.raises(ValueError, match="equal stages"):
        make_pipeline_train_step(cfg, mesh, n_micro=4)


def test_pipeline_params_are_left_as_they_are():
    """The loss reads the stacked leaves through views; gradients are
    taken on detached leaves, so the parameters gain no ``.grad``."""
    _, cfg = _cfgs()
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    before = tree_map(torch.clone, params)
    value_and_grads(make_pipeline_loss(cfg, mesh, n_micro=2), params,
                    _torch(_batch(cfg)))
    for (name, a), (_, b) in zip(leaf_paths(params), leaf_paths(before)):
        assert torch.equal(a, b) and a.grad is None, name


# ------------------------------------------------------------ launchers

def _run(module, *args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=env)


def test_train_launcher_pipeline(tmp_path):
    proc = _run("repro_torch.launch.train", "--arch", "starcoder2-3b",
                "--reduced", "--device", "cpu", "--pipeline", "2",
                "--steps", "12", "--global-batch", "8", "--seq", "32",
                "--lr", "2e-3", "--ckpt-dir", str(tmp_path / "ck"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "mesh: {'pipe': 2, 'data': 1, 'model': 1} (logical)" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) >= 2 and losses[-1] < losses[0], out
    assert out.rstrip().endswith("done")


def test_serve_launcher_host_devices_moe():
    proc = _run("repro_torch.launch.serve", "--arch", "grok-1-314b",
                "--reduced", "--device", "cpu", "--host-devices", "4",
                "--batch", "4", "--tokens", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mesh: {'data': 1, 'model': 4} (logical), kv_head_pad 2" \
        in proc.stdout
    assert "decoded 3 x batch 4" in proc.stdout


if __name__ == "__main__":
    _write_reference(sys.argv[1])
