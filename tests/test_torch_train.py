"""The port's training path against the JAX package's, at reduced sizes.

- ``lm_loss`` and the gradient of every parameter against
  ``jax.value_and_grad`` of ``repro``'s ``lm_loss``, in f32 compute, from
  the same weights (``repro``'s ``init_params`` converted) and the same
  batch (``SyntheticLM``, with some labels masked), on the reduced config
  of every family: starcoder2-3b, yi-6b (dense), llava-next-34b (vlm, fed
  embeds), grok-1-314b and deepseek-v3-671b (moe; MLA; a seeded router
  bias), mamba2-1.3b (ssm), zamba2-1.2b (hybrid, window 16) and
  seamless-m4t-large-v2 (encdec, fed frame embeds); f32 parameters for
  all (JAX returns bf16 parameters' gradients rounded to bf16). ``REPRO_ATTN_CHUNK=16``
  in both packages, so at S = 64 the multi-chunk (and, in the port, per
  chunk checkpointed) online softmax runs. The MoE kept masks of the
  forward are equal exactly (read from ``repro``'s own dispatch calls);
- remat ``none``, ``full`` and ``dots`` give bit-for-bit equal loss and
  gradients, and ``forward`` under ``no_grad`` equals it under grad;
- one ``make_train_step`` step, and one at ``microbatches=2``, against
  ``repro``'s jitted step: loss, grad_norm, parameters and optimizer state
  (adamw; adafactor on the reduced grok);
- ``abstract_params`` against ``repro.abstract_params`` for every arch at
  full size: the same tree, shapes and dtypes, on the meta device;
- the ports of ``tests/test_train_integration.py``'s
  ``test_loss_decreases_on_learnable_task`` and
  ``test_checkpoint_resume_is_bitwise``;
- the launcher in a subprocess, ``--device cpu --reduced --elastic
  --fake-hosts 2 --kill-host 1@5``: the failure, restore and ``done``
  lines, and final parameters bit for bit those of an unkilled run.

Tolerances. Loss: |port - repro| <= 1e-5 |repro| (the same f32 function,
sums in other orders: a few ulp). Gradients, per leaf: max|Δ| <= 1e-4
max|g_repro| (two layers of f32 backward, each sum in another order; a
wrong term moves a leaf by its own size). A train step: the loss and
grad_norm to 1e-5 relative; moments to 1e-4 of each leaf's max, as the
gradients. Parameters: AdamW's first step moves a weight by lr·(g / (|g|
+ eps) + wd·p), which turns a gradient's difference δ (up to 1e-4 of its
leaf's max, as above) into up to lr·min(2, 2δ / (|g| + eps)): each
element is held to that bound from the reference's own g (= m / (1 - b1))
plus 1e-6 |p| of rounding, so a gradient far above eps pins its weight to
a few ulp while one near eps may move by up to 2·lr, and a wrong sign,
bias correction or decay shows wherever |g| is not tiny. Adafactor's step
divides by factored row and column moments, not by |g|: 1e-2·lr. Inputs come from numpy with a seed.
"""

import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import all_archs
from repro.configs.registry import get_config as jx_get_config
from repro.models import moe as jx_moe
from repro.models import transformer as jx_tfm
from repro.train import optimizer as jx_opt
from repro.train.train_step import make_train_step as jx_make_train_step

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference, to_numpy)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (init_train_state, loss_and_grads,
                                          make_pipeline_train_step,
                                          make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["starcoder2-3b", "yi-6b", "llava-next-34b", "grok-1-314b",
         "deepseek-v3-671b", "mamba2-1.3b", "zamba2-1.2b",
         "seamless-m4t-large-v2"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SEQ, BATCH = 64, 2


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    # f32 parameters for every family (the moe configs store bf16, whose
    # gradients JAX returns rounded to bf16)
    kw.setdefault("param_dtype", "float32")
    if arch == "zamba2-1.2b":
        # the reduced config keeps its 4 096 window; 16 reaches it at S 64
        kw.setdefault("sliding_window", 16)
    return (jx_base.reduced(jx_get_config(arch), **kw),
            pt_base.reduced(get_config(arch), **kw))


def _reference_params(jcfg, seed=0):
    """``repro``'s parameters (as numpy), with a seeded nonzero router bias
    for the moe family."""
    jp = jax.tree.map(np.asarray,
                      jx_tfm.init_params(jcfg, jax.random.key(seed)))
    if "moe" in jp and "router_bias" in jp["moe"].get("moe", {}):
        bias = jp["moe"]["moe"]["router_bias"]
        jp["moe"]["moe"]["router_bias"] = (np.random.default_rng(7)
                                           .standard_normal(bias.shape)
                                           * 0.1).astype(bias.dtype)
    return jp


def _batch(cfg, seed=3, seq=SEQ, batch=BATCH):
    """A seeded ``SyntheticLM`` batch for ``cfg``'s family (numpy), with
    every fifth label of the first row masked (-1)."""
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                     embed_dim=cfg.d_model if (cfg.embed_inputs or
                                               cfg.family == "encdec")
                     else None,
                     encdec=cfg.family == "encdec")
    b = ds.batch_at(0)
    b["labels"][0, ::5] = -1
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def loss_cases():
    """Per arch: (configs, repro's params as numpy, the batch, repro's loss
    and gradients as numpy, repro's kept masks of the forward)."""
    out = {}
    old = os.environ.get("REPRO_ATTN_CHUNK")
    os.environ["REPRO_ATTN_CHUNK"] = "16"
    try:
        for arch in ARCHS:
            jcfg, pcfg = _cfgs(arch)
            jp = _reference_params(jcfg)
            b = _batch(pcfg)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            loss, grads = jax.value_and_grad(
                lambda p: jx_tfm.lm_loss(jcfg, p, jb))(
                    jax.tree.map(jnp.asarray, jp))
            kept = _reference_kept(jcfg, jp, jb) if pcfg.moe else None
            out[arch] = ((jcfg, pcfg), jp, b, float(loss),
                         jax.tree.map(np.asarray, grads), kept)
    finally:
        if old is None:
            os.environ.pop("REPRO_ATTN_CHUNK")
        else:
            os.environ["REPRO_ATTN_CHUNK"] = old
    return out


class _Dispatch:
    """Stands in for ``jax`` inside ``repro.models.moe`` and records the
    kept mask of each dispatch (the scatter ``vmap``'s fourth argument)."""

    def __init__(self):
        self.kept = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*xs):
            if len(xs) == 4:    # the scatter: tokens, experts, pos, kept
                self.kept.append(np.asarray(xs[3]).reshape(
                    -1, xs[3].shape[-1]))
            return mapped(*xs)
        return run


def _reference_kept(jcfg, jp, jb):
    """The kept masks of ``repro``'s ``lm_loss`` forward, run op by op (no
    scan or remat tracing, so its dispatch sees concrete arrays)."""
    rec = _Dispatch()
    real, remat = jx_moe.jax, os.environ.get("REPRO_REMAT")
    jx_moe.jax = rec
    os.environ["REPRO_REMAT"] = "none"
    try:
        with jax.disable_jit():
            jx_tfm.lm_loss(jcfg, jax.tree.map(jnp.asarray, jp), jb)
    finally:
        jx_moe.jax = real
        if remat is None:
            os.environ.pop("REPRO_REMAT")
        else:
            os.environ["REPRO_REMAT"] = remat
    return rec.kept


def _port_kept(pcfg, pp, batch, monkeypatch):
    """The kept mask of each ``moe_ffn`` call of the port's ``lm_loss``."""
    kept = []
    ffn = tfm.moe_ffn

    def recording(x, p, cfg_moe, *args):
        kept.append(moe.route(x.reshape(-1, x.shape[-1]), p,
                              cfg_moe).keep.numpy())
        return ffn(x, p, cfg_moe, *args)

    with monkeypatch.context() as m:
        m.setattr(tfm, "moe_ffn", recording)
        with torch.no_grad():
            tfm.lm_loss(pcfg, pp, batch)
    return kept


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(loss_cases, monkeypatch, arch):
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "16")
    (jcfg, pcfg), jp, b, want_loss, want_grads, want_kept = loss_cases[arch]
    pp = params_from_reference(jp, device="cpu")
    loss, grads = loss_and_grads(pcfg, pp, _torch_batch(b))
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss), (
        float(loss), want_loss)
    got, want = dict(_leaves(grads)), dict(_leaves(want_grads))
    assert got.keys() == want.keys()
    for name, g in got.items():
        ref = want[name]
        assert tuple(g.shape) == ref.shape and g.dtype == torch.float32, name
        scale = np.abs(ref).max()
        err = np.abs(g.numpy() - ref).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)
    if want_kept is not None:
        kept = _port_kept(pcfg, pp, _torch_batch(b), monkeypatch)
        assert len(kept) == len(want_kept) > 0
        for mine, ref in zip(kept, want_kept):
            np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v3-671b",
                                  "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_remat_policies_give_equal_grads(loss_cases, monkeypatch, arch):
    """none, full and dots: the same loss and gradients, bit for bit (the
    recomputation repeats the same ops on the same inputs); and the
    forward under no_grad equals the one under grad."""
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "16")
    (_, pcfg), jp, b, *_ = loss_cases[arch]
    pp = params_from_reference(jp, device="cpu")
    results = {}
    for policy in ("none", "full", "dots"):
        monkeypatch.setenv("REPRO_REMAT", policy)
        results[policy] = loss_and_grads(pcfg, pp, _torch_batch(b))
    loss, grads = results["none"]
    for policy in ("full", "dots"):
        other_loss, other = results[policy]
        assert torch.equal(other_loss, loss), policy
        for (name, g), (_, h) in zip(_leaves(grads), _leaves(other)):
            assert torch.equal(g, h), (policy, name)
    with torch.no_grad():
        assert torch.equal(tfm.lm_loss(pcfg, pp, _torch_batch(b)), loss)


def test_remat_policy_rejects_unknown_values(loss_cases, monkeypatch):
    (_, pcfg), jp, b, *_ = loss_cases["starcoder2-3b"]
    monkeypatch.setenv("REPRO_REMAT", "everything")
    with pytest.raises(ValueError, match="REPRO_REMAT"):
        loss_and_grads(pcfg, params_from_reference(jp, device="cpu"),
                       _torch_batch(b))


def _close(got, want, tol, what):
    """max|got - want| <= tol · max(max|want|, tiny)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch,microbatches,optimizer", [
    ("starcoder2-3b", 1, "adamw"), ("starcoder2-3b", 2, "adamw"),
    ("yi-6b", 2, "adamw"), ("grok-1-314b", 1, "adafactor"),
    ("mamba2-1.3b", 1, "adamw")],
    ids=["starcoder-mb1", "starcoder-mb2", "yi-mb2", "grok-adafactor",
         "mamba2-mb1"])
def test_train_step_matches_reference(arch, microbatches, optimizer):
    jcfg, pcfg = _cfgs(arch, optimizer=optimizer)
    jp = _reference_params(jcfg, seed=1)
    b = _batch(pcfg, seed=4, seq=32, batch=4)
    init, _ = jx_opt.make_optimizer(optimizer)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = init(jparams)
    step = jax.jit(jx_make_train_step(jcfg, lr=1e-3,
                                      microbatches=microbatches))
    want_p, want_s, want_m = step(jparams, jstate,
                                  {k: jnp.asarray(v) for k, v in b.items()})
    want_s = jax.tree.map(np.asarray, want_s)

    pp = params_from_reference(jp, device="cpu")
    pinit, _ = make_optimizer(optimizer)
    got_p, got_s, got_m = make_train_step(
        pcfg, lr=1e-3, microbatches=microbatches)(pp, pinit(pp),
                                                  _torch_batch(b))
    for key in ("loss", "grad_norm"):
        _close(float(got_m[key]), float(want_m[key]), 1e-5, key)
    lr = 1e-3
    for (name, g), (_, w) in zip(_leaves(to_numpy(got_p)),
                                 _leaves(jax.tree.map(np.asarray, want_p))):
        if optimizer == "adamw":
            grad = dict(_leaves(want_s.m))[name] / 0.1     # m = (1 - b1) g
            delta = GRAD_TOL * np.abs(grad).max()
            bound = (lr * np.minimum(2.0, 2 * delta / (np.abs(grad) + 1e-8))
                     + 1e-6 * np.abs(w))
        else:
            bound = 1e-2 * lr
        assert (np.abs(g - w) <= bound).all(), (
            name, float(np.abs(g - w).max()))
    got_s = to_numpy(got_s)
    assert type(got_s).__name__ == type(want_s).__name__
    assert int(got_s.step) == int(want_s.step) == 1
    for field in got_s._fields[1:]:
        for (name, g), (_, w) in zip(_leaves(getattr(got_s, field)),
                                     _leaves(getattr(want_s, field))):
            assert g.shape == w.shape, (field, name)
            _close(g, w, 1e-4, f"{field}{name}")


def test_opt_state_converts_both_ways():
    jcfg, _ = _cfgs("starcoder2-3b")
    jp = jax.tree.map(jnp.asarray, _reference_params(jcfg))
    for name in ("adamw", "adafactor"):
        state = jax.tree.map(np.asarray, jx_opt.make_optimizer(name)[0](jp))
        mine = opt_state_from_reference(state, device="cpu")
        assert type(mine).__name__ == type(state).__name__
        assert mine.step.dtype == torch.int32
        back = to_numpy(mine)
        for field in state._fields:
            for (n, a), (_, b) in zip(_leaves({"x": getattr(back, field)}),
                                      _leaves({"x": getattr(state, field)})):
                np.testing.assert_array_equal(a, b, err_msg=field + n)


@pytest.mark.parametrize("arch", all_archs())
def test_abstract_params_match_reference(arch):
    want = jx_tfm.abstract_params(jx_get_config(arch))
    got = tfm.abstract_params(get_config(arch))
    w, g = dict(_leaves(want)), dict(_leaves(got))
    assert w.keys() == g.keys()
    for name, leaf in g.items():
        assert leaf.is_meta, name
        assert tuple(leaf.shape) == w[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(
            w[name].dtype), name


def test_pipeline_train_step_waits_for_a9():
    """A9 is ported: the pipelined step builds for the dense family (its
    values are held in tests/test_torch_pipeline.py) and refuses the
    others, as the reference's does."""
    from repro_torch.launch.mesh import make_pipeline_mesh

    mesh = make_pipeline_mesh(2, 2, device="cpu")
    assert callable(make_pipeline_train_step(_cfgs("yi-6b")[1], mesh,
                                             n_micro=4))
    with pytest.raises(ValueError, match="dense family"):
        make_pipeline_train_step(_cfgs("mamba2-1.3b")[1], mesh, n_micro=4)


# ------------------------------- ports of tests/test_train_integration.py

def test_loss_decreases_on_learnable_task():
    cfg = pt_base.reduced(get_config("starcoder2-3b"), n_layers=2,
                          vocab_size=128)
    ds = SyntheticLM(cfg.vocab_size, 64, 8, learnable=True)
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    step_fn = make_train_step(cfg, lr=2e-3)
    losses = []
    for step in range(30):
        params, opt, m = step_fn(params, opt, _torch_batch(ds.batch_at(step)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::6]
    assert np.isfinite(losses).all()


def test_checkpoint_resume_is_bitwise():
    cfg = pt_base.reduced(get_config("yi-6b"), n_layers=1)
    ds = SyntheticLM(cfg.vocab_size, 32, 4, learnable=True)
    params, opt = init_train_state(cfg, seed=1, device="cpu")
    step_fn = make_train_step(cfg, lr=1e-3)

    for step in range(3):
        params, opt, _ = step_fn(params, opt, _torch_batch(ds.batch_at(step)))

    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, {"params": params, "opt": opt})
        # continue two more steps (in place: the saved copy is unchanged)
        p1, o1 = params, opt
        for step in (3, 4):
            p1, o1, m1 = step_fn(p1, o1, _torch_batch(ds.batch_at(step)))
        # restore and replay: deterministic data -> identical result
        init, _ = make_optimizer(cfg.optimizer)
        like = tfm.abstract_params(cfg)
        state = ckpt.restore(d, 3, {"params": like, "opt": init(like)},
                             device="cpu")
        p2, o2 = state["params"], state["opt"]
        for step in (3, 4):
            p2, o2, m2 = step_fn(p2, o2, _torch_batch(ds.batch_at(step)))
    assert float(m1["loss"]) == float(m2["loss"])
    for (_, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert torch.equal(a, b)
    assert torch.equal(o1.step, o2.step)


# ---------------------------------------------------------- the launcher

def _launch(ckpt_dir, *extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "starcoder2-3b", "--reduced", "--steps", "8",
         "--device", "cpu", "--elastic", "--fake-hosts", "2",
         "--lease", "2", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3",
         "--global-batch", "4", "--seq", "16", *extra],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)


def test_elastic_launcher_survives_fake_host_kill(tmp_path):
    """2 fake hosts on the one device, host 1 silent from step 5: the
    controller declares it dead at step 7 (lease 2), the launcher restores
    the step-6 checkpoint, runs step 7 again and ends with the parameters
    of a run that lost no host, bit for bit."""
    killed = _launch(tmp_path / "killed", "--kill-host", "1@5")
    assert killed.returncode == 0, killed.stderr[-2000:]
    out = killed.stdout
    assert "host failure: survivors [0], re-mesh (1, 1), restore step 6" \
        in out
    assert "elastic restore from step 6 (resuming at step 7)" in out
    assert out.count("mesh: ") == 2  # one run before the failure, one after
    assert out.rstrip().endswith("done")
    clean = _launch(tmp_path / "clean")
    assert clean.returncode == 0, clean.stderr[-2000:]
    assert "host failure" not in clean.stdout
    cfg = pt_base.reduced(get_config("starcoder2-3b"))
    init, _ = make_optimizer(cfg.optimizer)
    like = tfm.abstract_params(cfg)
    like = {"params": like, "opt": init(like)}
    assert ckpt.latest_step(tmp_path / "killed") == 7
    a = ckpt.restore(tmp_path / "killed", 7, like, device="cpu")
    b = ckpt.restore(tmp_path / "clean", 7, like, device="cpu")
    for (name, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert torch.equal(x, y), name
    assert int(a["opt"].step) == int(b["opt"].step) == 8


def test_launcher_refuses_what_is_not_ported(tmp_path):
    """The pipeline and the meshes are ported; what the launcher still
    refuses, as the reference's does: a pipeline of a non-dense family, of
    unequal stages, or under the elastic loop."""
    for arch, flags, what in (
            ("mamba2-1.3b", ["--pipeline", "2"], "dense family"),
            ("yi-6b", ["--pipeline", "3"], "equal pipeline stages"),
            ("yi-6b", ["--pipeline", "2", "--elastic"],
             "does not compose")):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--reduced", "--device", "cpu", "--steps", "1",
             "--ckpt-dir", str(tmp_path / "ck"), *flags],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
        assert proc.returncode != 0 and what in proc.stderr, proc.stderr
