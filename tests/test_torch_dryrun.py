"""The port's dry run (``launch/dryrun.py``) on the CPU.

- a reduced dense prefill's traced FLOPs equal the analytic sum of its
  matrix products (projections, the plain attention's q·kᵀ and p·v over
  every (query, key) pair, the FFN and the head), exactly, at one KV
  chunk and at several (``REPRO_ATTN_CHUNK``), GELU and SwiGLU;
- a reduced train step traces more than 3x its prefill (forward,
  recompute under remat full, backward), a decode step far less;
- ``run_cell`` on reduced configs of every family and kind, on the pod,
  multi-pod and one-device meshes: the JSON keys of the reference that
  carry over, ``status`` ok, the even FLOP split, the null XLA fields
  with their reason, ``fits_80gb`` on one device;
- the full-config sweep of every arch × shape × mesh kind without a
  trace: specs and argument bytes (``long_500k`` skipped where the
  reference skips it), and on one device the argument bytes equal the
  arguments' own bytes;
- the CLI writes one JSON per cell and skips cells already written.
"""

import json
import os

import pytest

from repro_torch.configs.base import SHAPES, reduced, shapes_for
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.dist import sharding as sh

KEYS = {"arch", "shape", "kind", "mesh", "status", "seq_len",
        "global_batch", "n_params", "n_active_params", "n_chips",
        "per_device", "hlo_lines", "trace_s"}
FAMILIES = ["starcoder2-3b", "yi-6b", "llava-next-34b", "grok-1-314b",
            "deepseek-v3-671b", "mamba2-1.3b", "zamba2-1.2b",
            "seamless-m4t-large-v2"]


def _prefill_flops(cfg, b, s):
    """2·M·N·K over every product of a dense prefill of b x s tokens."""
    t, d, hd = b * s, cfg.d_model, cfg.head_dim
    proj = 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    attn = 2 * 2 * b * cfg.n_heads * s * s * hd
    ffn = 2 * t * d * cfg.d_ff * (3 if cfg.ffn == "swiglu" else 2)
    head = 2 * t * d * cfg.vocab_size
    return cfg.n_layers * (proj + attn + ffn) + head


@pytest.mark.parametrize("chunk", [None, "16"], ids=["one-chunk", "chunk16"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "yi-6b"])
def test_prefill_flops_are_the_products(monkeypatch, arch, chunk):
    if chunk:
        monkeypatch.setenv("REPRO_ATTN_CHUNK", chunk)
    cfg = reduced(get_config(arch))
    got = dryrun.run_cell(arch, "prefill_32k", "1x1", seq=64,
                          global_batch=2, cfg=cfg)
    assert got["per_device"]["flops"] == _prefill_flops(cfg, 2, 64)
    assert got["per_device"]["flops_total"] == got["per_device"]["flops"]


def test_train_and_decode_flops_bracket_the_prefill():
    cfg = reduced(get_config("starcoder2-3b"))
    kw = {"seq": 64, "global_batch": 2, "cfg": cfg}
    prefill = dryrun.run_cell("starcoder2-3b", "prefill_32k", "1x1", **kw)
    train = dryrun.run_cell("starcoder2-3b", "train_4k", "1x1", **kw)
    decode = dryrun.run_cell("starcoder2-3b", "decode_32k", "1x1", **kw)
    p = prefill["per_device"]["flops"]
    assert 3 * p < train["per_device"]["flops"] < 5 * p
    assert 0 < decode["per_device"]["flops"] < p / 10


@pytest.mark.parametrize("kind", ["pod", "multi", "1x1"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_records(arch, kind):
    cfg = reduced(get_config(arch))
    for cell in shapes_for(cfg):
        r = dryrun.run_cell(arch, cell.name, kind, seq=32, global_batch=4,
                            cfg=cfg)
        assert KEYS <= r.keys(), cell.name
        assert r["status"] == "ok" and r["kind"] == cell.kind
        assert r["n_chips"] == {"pod": 256, "multi": 512, "1x1": 1}[kind]
        assert r["mesh"] == dict(dryrun.make_mesh(kind).shape)
        pd = r["per_device"]
        assert pd["flops"] > 0
        assert pd["flops"] * r["n_chips"] == pd["flops_total"]
        assert pd["argument_bytes"] > 0
        for key in ("temp_bytes", "bytes_accessed", "collective_bytes"):
            assert pd[key] is None
        assert pd["reason"] and r["hlo_lines"] is None
        assert ("fits_80gb" in r) == (kind == "1x1")
        json.dumps(r)


def _bytes(tree):
    return sum(x.numel() * x.element_size() for x in sh.spec_leaves(
        sh.map_tree(lambda x: x, tree)) if hasattr(x, "element_size"))


@pytest.mark.parametrize("arch", all_archs())
def test_full_config_sweep_without_a_trace(arch):
    cfg = get_config(arch)
    names = {c.name for c in shapes_for(cfg)}
    for kind in ("pod", "multi", "1x1"):
        mesh = dryrun.make_mesh(kind)
        for cell in SHAPES:
            r = dryrun.run_cell(arch, cell.name, kind, trace=False)
            if cell.name not in names:
                assert r["status"] == "skipped" and cell.name == "long_500k"
                continue
            assert r["status"] == "ok" and r["per_device"]["flops"] is None
            args, _ = input_specs(cfg, cell, mesh)
            full = _bytes(args)
            got = r["per_device"]["argument_bytes"]
            if kind == "1x1":
                assert got == full
                assert r["fits_80gb"] == (full <= 80e9)
            else:
                assert full / mesh.size <= got < full
    # yi-34b's f32 params and AdamW moments alone pass 80 GB
    assert not dryrun.run_cell("yi-34b", "train_4k", "1x1",
                               trace=False)["fits_80gb"]


def test_cli_writes_and_skips(tmp_path, capsys):
    argv = ["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--mesh",
            "1x1", "--seq", "256", "--global-batch", "2", "--out-dir",
            str(tmp_path)]
    dryrun.main(argv)
    path = tmp_path / "mamba2-1.3b__decode_32k__1x1_s256_b2.json"
    r = json.loads(path.read_text())
    assert r["status"] == "ok" and r["seq_len"] == 256
    assert r["global_batch"] == 2 and r["fits_80gb"]
    dryrun.main(argv)
    assert "[skip existing]" in capsys.readouterr().out
    assert os.listdir(tmp_path) == [path.name]
