"""The port's training substrate against the JAX package's: optimizers,
data and checkpoints.

- ``adamw_update`` and ``adafactor_update`` against ``repro``'s, three
  steps on a tree with stacked ``[L, a, b]`` leaves, 2-D and 1-D leaves,
  from the same parameters and gradients (numpy, seeded), with
  ``REPRO_OPT_SCAN`` on and off in both packages: parameters and state
  within 1e-6 of each leaf's max (the same f32 ops; XLA and PyTorch may
  round a mean's sum in another order). Adafactor's per-layer clip makes
  the flag change its result, in both packages alike;
- the ports of ``tests/test_substrate.py``'s checkpoint round trip, atomic
  publish and GC, async quiesce, AdamW on a quadratic (property-based) and
  Adafactor's factored state;
- ``SyntheticLM`` (plain, learnable, embeds, encdec) and
  ``PackedBinaryDataset`` batches bit for bit ``repro``'s;
- checkpoints across packages: the port restores ``repro``'s and
  ``repro`` restores the port's, bit for bit, bf16 and the NamedTuple
  optimizer state included; the manifests name the same leaves;
- a snapshot is taken when ``save`` returns: an in-place update made
  after it does not reach the checkpoint.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.train import checkpoint as jx_ckpt
from repro.train import optimizer as jx_opt
from repro.train.data import PackedBinaryDataset as JxPacked
from repro.train.data import SyntheticLM as JxSyntheticLM

from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference, to_numpy)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import PackedBinaryDataset, SyntheticLM
from repro_torch.train.optimizer import (AdamWState, adafactor_init,
                                         adafactor_update, adamw_init,
                                         adamw_update, make_optimizer)
from repro_torch.train.tree import leaf_paths

OPT_TOL = 1e-6


def _tree(rng, scale=1.0):
    """Stacked [3, 6, 5] and [3, 4, 2, 3] leaves, a [6, 5] matrix and a [5]
    vector, as numpy f32."""
    return {"stack": {"w": (rng.standard_normal((3, 6, 5)) * scale)
                      .astype(np.float32),
                      "e": (rng.standard_normal((3, 4, 2, 3)) * scale)
                      .astype(np.float32)},
            "m": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _close(got, want, what):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape, (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= OPT_TOL * scale, (what, name)


def _run_both(name, monkeypatch, scan, steps=3, **kw):
    monkeypatch.setenv("REPRO_OPT_SCAN", scan)
    rng = np.random.default_rng(5)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(steps)]
    init, update = jx_opt.make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, p0)
    js = init(jp)
    for g in grads:
        jp, js = update(jp, jax.tree.map(jnp.asarray, g), js, **kw)
    pinit, pupdate = make_optimizer(name)
    pp = params_from_reference(p0, device="cpu")
    ps = pinit(pp)
    for g in grads:
        pp, ps = pupdate(pp, params_from_reference(g, device="cpu"), ps, **kw)
    return (to_numpy(pp), to_numpy(ps)), (jax.tree.map(np.asarray, jp),
                                          jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("scan", ["1", "0"], ids=["scan", "whole"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(monkeypatch, name, scan):
    kw = {"lr": 1e-2} if name == "adamw" else {"lr": 1e-2, "clip": 0.5}
    (pp, ps), (jp, js) = _run_both(name, monkeypatch, scan, **kw)
    _close(pp, jp, "params")
    assert type(ps).__name__ == type(js).__name__
    assert int(ps.step) == int(js.step) == 3
    for field in ps._fields[1:]:
        _close(getattr(ps, field), getattr(js, field), field)


def test_adafactor_per_layer_clip_follows_the_flag(monkeypatch):
    """With the per-layer loop the clip norm is each layer slice's own, so
    the flag changes the stacked leaves' result (and nothing else), the
    same way in both packages."""
    kw = {"lr": 1e-2, "clip": 0.5}
    (scan_p, _), (scan_j, _) = _run_both("adafactor", monkeypatch, "1", **kw)
    (whole_p, _), (whole_j, _) = _run_both("adafactor", monkeypatch, "0",
                                           **kw)
    for port, ref in ((scan_p, scan_j), (whole_p, whole_j)):
        _close(port, ref, "params")
    assert not np.allclose(scan_p["stack"]["w"], whole_p["stack"]["w"],
                           rtol=1e-4, atol=0)
    np.testing.assert_array_equal(scan_p["m"], whole_p["m"])


def test_optimizer_updates_in_place():
    p = {"w": torch.zeros(3, 4, 5), "b": torch.ones(5)}
    w, b = p["w"], p["b"]
    for init, update in (make_optimizer("adamw"),
                         make_optimizer("adafactor")):
        state = init(p)
        g = {"w": torch.ones(3, 4, 5), "b": torch.ones(5)}
        new, state = update(p, g, state)
        assert new["w"] is w and new["b"] is b
        assert not torch.equal(w, torch.zeros(3, 4, 5))
        assert state.step.dtype == torch.int32 and int(state.step) == 1
    with pytest.raises(ValueError):
        make_optimizer("sgd")


# ------------------------------------------- ports of test_substrate.py

def test_checkpoint_roundtrip():
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, tree)
        out = ckpt.restore(d, 3, tree)
        assert torch.equal(out["a"], tree["a"])
        assert out["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(out["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_atomic_publish_and_gc():
    tree = {"w": torch.zeros((4,))}
    with tempfile.TemporaryDirectory() as d:
        c = ckpt.AsyncCheckpointer(d, keep=2)
        for step in (1, 2, 3, 4):
            c.save(step, tree)
        c.wait()
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [3, 4]  # gc kept last 2, no .tmp residue
        assert not any(x.endswith(".tmp") for x in os.listdir(d))
        assert ckpt.latest_step(d) == 4


def test_async_checkpoint_quiesces():
    tree = {"w": torch.ones((256, 256))}
    with tempfile.TemporaryDirectory() as d:
        c = ckpt.AsyncCheckpointer(d)
        c.save(1, tree)
        c.wait()  # the completion-protocol role: no in-flight writes after
        out = ckpt.restore(d, 1, tree)
        assert torch.equal(out["w"], tree["w"])


@settings(deadline=None, max_examples=10)
@given(seed=st.integers(0, 2**31))
def test_adamw_reduces_quadratic(seed):
    target = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        8).astype(np.float32))
    params = {"w": torch.zeros((8,))}
    state = adamw_init(params)

    def loss(w):
        return torch.sum((w - target) ** 2)

    l0 = float(loss(params["w"]))
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(loss(w), w)
        params, state = adamw_update(params, {"w": g}, state, lr=5e-2,
                                     weight_decay=0.0)
    assert float(loss(params["w"])) < l0 * 0.5


def test_adafactor_factored_state_is_small():
    params = {"w": torch.zeros((256, 512)), "b": torch.zeros((512,))}
    state = adafactor_init(params)
    assert state.vr["w"].shape == (256,)
    assert state.vc["w"].shape == (512,)
    assert state.vr["b"].shape == (512,)

    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.sum(live["w"] ** 2) + torch.sum((live["b"] - 1.0) ** 2)
    gw, gb = torch.autograd.grad(loss, [live["w"], live["b"]])
    new, state = adafactor_update(params, {"w": gw, "b": gb}, state, lr=1e-2)
    assert all(torch.isfinite(x).all() for x in new.values())


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("kw", [
    {}, {"learnable": True}, {"embed_dim": 8},
    {"embed_dim": 8, "encdec": True},
    {"embed_dim": 8, "encdec": True, "learnable": True}],
    ids=["tokens", "learnable", "embeds", "encdec", "encdec-learnable"])
def test_synthetic_batches_are_the_reference_bit_for_bit(kw):
    mine = SyntheticLM(100, 16, 4, seed=7, **kw)
    ref = JxSyntheticLM(100, 16, 4, seed=7, **kw)
    for step in (0, 5, 123):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    first = next(iter(mine))
    np.testing.assert_array_equal(first["labels"],
                                  ref.batch_at(0)["labels"])


def test_synthetic_data_deterministic_in_step():
    ds = SyntheticLM(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch_at(6)["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape


def test_packed_binary_dataset_matches_reference():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokens.bin")
        PackedBinaryDataset.write(path, np.arange(1000, dtype=np.uint32) % 50)
        mine, ref = PackedBinaryDataset(path, 32, 4), JxPacked(path, 32, 4)
        for step in (0, 3, 40):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        with pytest.raises(ValueError):
            PackedBinaryDataset(path, 512, 4)


# ------------------------------------------------ checkpoints, both ways

def _reference_tree():
    """A training state as ``repro`` holds it: f32 and bf16 parameters and
    an AdamWState, numpy / jax arrays, from a seed."""
    rng = np.random.default_rng(9)
    params = {"dense": {"w": rng.standard_normal((2, 3, 4)).astype(
        np.float32)},
        "embed": rng.standard_normal((5, 4)).astype(ml_dtypes.bfloat16),
        "norm": rng.standard_normal((4,)).astype(np.float32)}
    state = jx_opt.adamw_init(jax.tree.map(jnp.asarray, params))
    state = state._replace(step=jnp.asarray(7, jnp.int32),
                           m=jax.tree.map(lambda a: a + 1.5, state.m))
    return {"params": params, "opt": jax.tree.map(np.asarray, state)}


def _port_tree(tree):
    return {"params": params_from_reference(tree["params"], device="cpu"),
            "opt": opt_state_from_reference(tree["opt"], device="cpu")}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_port_restores_the_references_checkpoint():
    tree = _reference_tree()
    with tempfile.TemporaryDirectory() as d:
        jx_ckpt.save(d, 7, tree)
        like = _port_tree(jax.tree.map(np.zeros_like, tree))
        out = ckpt.restore(d, 7, like, device="cpu")
    assert isinstance(out["opt"], AdamWState)
    assert out["params"]["embed"].dtype == torch.bfloat16
    want = _port_tree(tree)
    for (name, a), (_, b) in zip(leaf_paths(out), leaf_paths(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_reference_restores_the_ports_checkpoint():
    tree = _reference_tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, _port_tree(tree))
        jx_dir = os.path.join(d, "jx")
        jx_ckpt.save(jx_dir, 7, tree)
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            mine = json.load(f)
        with open(os.path.join(jx_dir, "step_00000007",
                               "manifest.json")) as f:
            ref = json.load(f)
        assert mine == ref            # same names, files, shapes, dtypes
        out = jx_ckpt.restore(d, 7, tree)
    for (name, a), (_, b) in zip(_leaves(out["params"]),
                                 _leaves(tree["params"])):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert int(out["opt"].step) == 7
    for field in ("m", "v"):
        for (name, a), (_, b) in zip(_leaves(getattr(out["opt"], field)),
                                     _leaves(getattr(tree["opt"], field))):
            np.testing.assert_array_equal(a, b, err_msg=field + name)


@pytest.mark.parametrize("mode", ["async", "non-blocking"])
def test_snapshot_is_taken_before_save_returns(mode):
    """The port updates parameters in place: an update right after ``save``
    returns must not reach the checkpoint being written."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    tree = {"w": w, "opt": AdamWState(step=torch.tensor(3, dtype=torch.int32),
                                      m={"w": w.clone()}, v={"w": w * 2})}
    with tempfile.TemporaryDirectory() as d:
        if mode == "async":
            c = ckpt.AsyncCheckpointer(d)
            c.save(1, tree)
        else:
            thread = ckpt.save(d, 1, tree, blocking=False)
        w.add_(1.0)                               # the next step, in place
        tree["opt"].m["w"].mul_(0.0)
        if mode == "async":
            c.wait()
        else:
            thread.join(timeout=60)
            assert not thread.is_alive()
        out = ckpt.restore(d, 1, tree)
    assert torch.equal(out["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(out["opt"].m["w"], out["w"])
    assert int(out["opt"].step) == 3
