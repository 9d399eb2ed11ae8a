"""The application modules, their counts and the window's check, at tiny
sizes on the CPU (the card's own run is the one ``cuda`` test)."""

from __future__ import annotations

import time
from collections import Counter

import pytest
import torch

from portbench import loop, spec
from portbench.tests import tiny
from portbench.yardstick import gemm_task, least_s

BENCH = spec.benchmark()


def _cfg(name, **sizes):
    cfg = spec.config(BENCH, name)
    cfg.update(tiny.SIZES[name], **sizes)
    return cfg


@pytest.mark.parametrize("name,nb", [("cholesky-16k", 3), ("cholesky-16k", 5),
                                     ("gemm2d-8k", 2), ("gemm2d-8k", 4)])
def test_real_tasks_and_flops_are_exact(name, nb):
    cfg = _cfg(name, nb=nb, N=nb * 16)
    app = spec.module("apps", cfg["app"])
    prog = app.build(cfg)
    kinds = Counter(task[0] for task in prog.schedule.level_of)
    real = app.real_tasks(cfg)
    assert real == {t: kinds[t] for t in real}
    b = cfg["b"]
    if name.startswith("cholesky"):
        # the blocked algorithm's count: potrf b³/3, trsm b³, syrk b³ (one
        # triangle), gemm 2b³ — N³/3 in all
        per = {"potrf": b ** 3 / 3, "trsm": b ** 3, "syrk": b ** 3,
               "gemm": 2 * b ** 3}
        assert sum(per[t] * c for t, c in kinds.items()) == app.flops(cfg)
        assert app.task_cost(cfg) == {"syrk": (2 * b ** 3, 12 * b * b),
                                      "gemm": (2 * b ** 3, 16 * b * b)}
    else:
        assert kinds["gemm"] * 2 * b ** 3 == app.flops(cfg)
        assert app.task_cost(cfg) == {"gemm": (2 * b ** 3, 16 * b * b)}


def test_least_time_takes_the_larger_bound():
    flops, nbytes = gemm_task(512, 512, 512, 3)
    assert least_s(flops, nbytes) == pytest.approx(2 * 512 ** 3 / 67e12)
    assert least_s(0.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["cholesky-16k", "gemm2d-8k"])
def test_slot_count_of_a_known_lowering(name):
    from repro_torch.linalg.cholesky import cholesky_bodies
    from repro_torch.linalg.gemm import gemm_bodies

    cfg = _cfg(name)
    app = spec.module("apps", cfg["app"])
    prog = app.build(cfg)
    body = loop.Body(lambda a, b: a @ b, mark=False)
    bodies = (cholesky_bodies if name.startswith("cholesky")
              else gemm_bodies)(body)
    # unrolled without overlap: each wavefront's own tables, padded to
    # its largest shard
    ex = prog.executor(bodies, device="cpu", scan=False, overlap=False)
    typed = app.real_tasks(cfg)
    want = sum(out.shape[0] * out.shape[1] for tabs in prog.tables
               for t, (_, out) in tabs.items() if t in typed)
    inp = app.make_input(cfg, 5, "cpu")
    ex(prog.pack(app.blocks(cfg, inp), device="cpu"))
    assert body.slots == want and body.calls > 0
    reader = spec.module("metrics", "slot_util")
    util = reader.read({"slots": body.slots, "n_steps": 1,
                        "real_tasks": sum(typed.values())})
    assert util == pytest.approx(100.0 * sum(typed.values()) / want)
    assert 0 < util <= 100


@pytest.mark.parametrize("name", ["cholesky-16k", "gemm2d-8k"])
def test_apps_agree_with_the_plain_reference(name):
    cfg = _cfg(name)
    app = spec.module("apps", cfg["app"])
    ref = spec.module("reference", cfg["app"])
    prog = app.build(cfg)
    inp = app.make_input(cfg, 11, "cpu")
    body = loop.Body(lambda a, b: a @ b, mark=False)
    out = app.executor(prog, body, "cpu")(
        prog.pack(app.blocks(cfg, inp), device="cpu"))
    want = app.reference(cfg, inp, ref, dtype=torch.float64)
    b = cfg["b"]
    for blk, (r, c) in app.result_blocks(cfg):
        s, slot = prog.slot_of[blk]
        block = want[r * b:(r + 1) * b, c * b:(c + 1) * b]
        err = (out[s, slot].double() - block).abs().max() / block.abs().max()
        assert err < 1e-5, (blk, float(err))


def test_inputs_repeat_from_their_seed():
    cfg = _cfg("cholesky-16k")
    app = spec.module("apps", cfg["app"])
    a = app.make_input(cfg, 2 ** 31 + 9, "cpu")["a"]
    assert torch.equal(a, app.make_input(cfg, 2 ** 31 + 9, "cpu")["a"])
    assert not torch.equal(a, app.make_input(cfg, 2 ** 31 + 10, "cpu")["a"])
    assert torch.equal(a, a.mT)
    assert bool((torch.linalg.eigvalsh(a.double()) > 1).all())


def test_one_process_cell_end_to_end(tmp_path):
    out = loop.run_cell("chol16k-1p", 2 ** 33 + 1, 0.2, False,
                        start_epoch=time.time(), device="cpu",
                        bench=tiny.bench(tmp_path))
    assert out["correct"] and out["failed"] == 0
    assert out["checked"]["steps_checked"] == min(4, out["attempted"])
    assert set(out["metrics"]) == {"setup_s", "step_ms"}
    # this test process may hold JAX from other tests; nothing more
    assert out["forbidden"] == loop.forbidden_modules()


def test_ranked_cell_end_to_end(tmp_path):
    out = loop.run_cell("gemm8k-r4", 2 ** 33 + 2, 0.2, True,
                        start_epoch=time.time(), device="cpu",
                        bench=tiny.bench(tmp_path), mix_overrides=tiny.MIX)
    assert out["correct"] and out["failed"] == 0
    assert out["checked"]["steps_checked"] == min(8, out["attempted"])
    got = out["metrics"]
    # the device metrics need a card; every other per-layer one is here
    assert {"build_s", "slot_util", "exchange_frac", "step_mfu"} <= set(got)
    assert 0 < got["slot_util"]["value"] <= 100
    assert 0 < got["exchange_frac"]["value"] < 100
    # the rank processes hold no JAX (this test process may, from others)
    assert out["forbidden"] == loop.forbidden_modules()


@pytest.mark.cuda
def test_one_process_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    out = loop.run_cell("chol16k-1p", 3, 0.5, True, start_epoch=time.time(),
                        device="cuda", bench=tiny.bench(tmp_path))
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["gemm_body_roofline"]["value"] <= 100
