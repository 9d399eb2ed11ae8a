"""The plain version of the port's flash attention (what the wrapper runs on
CPU tensors) against the JAX package's Pallas kernel in interpret mode and
its jnp oracle, and the attention-chain PTG on the port's executor against
the JAX package's executor.

- ``attention`` / ``flash_attention`` / ``mha_ref`` over
  ``tests/test_kernels.py``'s sweep (MHA, GQA, MQA, Lk > Lq, uneven tiles,
  causal and full), the long-sequence case, and the executor's batched
  ``task_attention`` form against ``vmap(task_attention)``. Tolerances are
  the reference's: f32 2e-5 (the two differ only in the order of f32 sums
  and in the online softmax's rescaling, a few ulp), bf16 2e-2 (both round
  an f32 result to bf16 once: one bf16 ulp is 2^-8 relative).
- The attention chain of ``multi_device_cases.case_pallas_bodies`` (depth 6,
  seq 32, dim 16, 2 shards), on the port's executor with ``task_attention``
  bodies (the plain version on the CPU), against the JAX package's executor
  on ``mha_ref`` bodies, run once in a subprocess with 2 forced host
  devices, at 2e-5. The JAX package's ``pallas_bodies`` case itself fails
  under jax 0.9.0 (ROADMAP, "Reference caveats"); its jnp-body lowering
  runs.

Inputs come from numpy with a seed and go to both frameworks. Run as a
script (``python tests/test_torch_flash_attention.py OUT.npz``) this file
writes the JAX package's attention-chain outputs.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jx_flash_attention)
from repro.kernels.flash_attention.ops import task_attention as jx_task_attn
from repro.kernels.flash_attention.ref import mha_ref as jx_mha_ref

from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 mha_ref, task_attention)
from repro_torch.ptg import Graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CHAIN = dict(depth=6, seq=32, dim=16, n_shards=2)


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# ------------------------------------------------- the kernel's plain form

@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,bq,bk", [
    (1, 4, 4, 128, 128, 64, 64, 64),     # MHA
    (2, 8, 2, 128, 128, 64, 64, 64),     # GQA 4:1
    (1, 4, 1, 64, 256, 32, 64, 64),      # MQA, kv longer than q
    (1, 2, 2, 256, 256, 128, 128, 64),   # uneven q/kv tiles
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_sweep(b, hq, hkv, lq, lk, d, bq, bk, causal,
                                       dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(1, (b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)), dtype)
    want_pallas = np.asarray(jx_flash_attention(
        jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True), np.float32)
    want_ref = np.asarray(jx_mha_ref(jq, jk, jv, causal=causal), np.float32)
    for got in (mha_ref(tq, tk, tv, causal=causal),
                flash_attention(tq, tk, tv, causal=causal),
                attention(tq, tk, tv, causal=causal)):
        assert got.dtype == tq.dtype and got.shape == (b, hq, lq, d)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_pallas, **_tol(dtype))
        np.testing.assert_allclose(got, want_ref, **_tol(dtype))


def test_plain_matches_reference_on_long_seq():
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(2, (1, 2, 512, 64), (1, 2, 512, 64), (1, 2, 512, 64)),
        "float32")
    want = np.asarray(jx_flash_attention(jq, jk, jv, causal=True, bq=128,
                                         bk=128, interpret=True))
    np.testing.assert_allclose(attention(tq, tk, tv).numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_task_attention_matches_reference(causal):
    """The executor's batched body form against ``vmap(task_attention)``
    (the fused Pallas launch, interpret mode) of the JAX package."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(10, (3, 32, 16), (3, 32, 16), (3, 32, 16)), "float32")
    want = np.asarray(jax.vmap(lambda q_, k_, v_: jx_task_attn(
        q_, k_, v_, causal=causal))(jq, jk, jv))
    got = task_attention(tq, tk, tv, causal=causal)
    assert got.shape == (3, 32, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, (2, 4, 16, 8),
                                                    (2, 2, 16, 8),
                                                    (2, 2, 16, 8)))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v), mha_ref(q, k, v),
                               rtol=0, atol=0)
    assert flash_attention.launches == before


def test_plain_masks_the_keys_after_each_query():
    """Causal with Lk > Lq: query i sits at position Lk - Lq + i and sees
    exactly the keys up to it, so changing a later key leaves it alone."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, (1, 1, 4, 8),
                                                    (1, 1, 10, 8),
                                                    (1, 1, 10, 8)))
    out = mha_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 7:] += 5.0                        # keys after query 0 (pos 6)
    v2[:, :, 7:] -= 3.0
    out2 = mha_ref(q, k2, v2)
    torch.testing.assert_close(out2[:, :, 0], out[:, :, 0], rtol=0, atol=0)
    assert not torch.equal(out2[:, :, 1:], out[:, :, 1:])


# ------------------------------------------------- the attention chain PTG

def attn_graph(graph_cls, depth, seq, dim, n_shards):
    """The attention chain of ``multi_device_cases.case_pallas_bodies``:
    task ``l`` self-attends the previous layer's block."""
    g = graph_cls("attnchain", n_shards=n_shards,
                  owner=lambda blk: blk[1] % n_shards,
                  block_shape=(seq, dim))
    g.task_type("src",                    # publish the input as a task
                space=lambda: ((0,),),    # output (communicated blocks
                writes=lambda l: ("x", 0),  # are single-assignment)
                reads=lambda l: [("in", 0)])
    g.task_type("attn",
                space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l),
                reads=lambda l: [("x", l - 1)] * 3)
    return g


def chain_blocks(depth, seq, dim, **_):
    rng = np.random.default_rng(7)
    blocks = {("in", 0): rng.standard_normal((seq, dim)).astype(np.float32)}
    for l in range(depth + 1):
        blocks[("x", l)] = np.zeros((seq, dim), np.float32)
    return blocks


def _write_reference(path):
    from repro.ptg import Graph as JxGraph

    n = CHAIN["n_shards"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shards",))
    prog = attn_graph(JxGraph, **CHAIN).to_program()
    body = {"src": lambda x: x,
            "attn": lambda q, k, v: jx_mha_ref(
                q[None, None], k[None, None], v[None, None],
                causal=True)[0, 0]}
    with mesh:
        out = jax.jit(prog.auto_executor(body, mesh))(
            jnp.asarray(prog.pack(chain_blocks(**CHAIN))))
    unpacked = prog.unpack(np.asarray(out))
    np.savez(path, **{f"x{l}": np.asarray(unpacked[("x", l)])
                      for l in range(CHAIN["depth"] + 1)})


@pytest.fixture(scope="module")
def chain_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_attn_chain") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _port_chain_bodies(attn):
    return {"src": lambda x: x, "attn": attn}


@pytest.mark.parametrize("policy", ["auto", "unrolled", "dense_scan"])
def test_attention_chain_matches_jax_executor(chain_reference, policy):
    prog = attn_graph(Graph, **CHAIN).to_program()
    bodies = _port_chain_bodies(task_attention)
    if policy == "auto":
        ex = prog.auto_executor(bodies, device="cpu")
    else:
        ex = prog.executor(bodies, device="cpu",
                           scan=policy == "dense_scan")
    out = prog.unpack(ex(prog.pack(chain_blocks(**CHAIN), device="cpu")))
    # one body call per wavefront holding an attn task; the dense scan
    # walks every wavefront with padded tables, the src one included
    assert ex.calls["attn"] == CHAIN["depth"] + (policy == "dense_scan")
    for l in range(1, CHAIN["depth"] + 1):
        np.testing.assert_allclose(out[("x", l)].numpy(),
                                   chain_reference[f"x{l}"], rtol=2e-5,
                                   atol=2e-5, err_msg=f"x{l} ({policy})")


def test_attention_chain_matches_mha_ref_bodies():
    """``task_attention`` bodies against per-block ``mha_ref`` bodies of the
    same program (the JAX package's case (b) oracle), bit for bit on the
    CPU, where both are the plain version."""
    prog = attn_graph(Graph, **CHAIN).to_program()
    packed = prog.pack(chain_blocks(**CHAIN), device="cpu")
    got = prog.auto_executor(_port_chain_bodies(task_attention),
                             device="cpu")(packed)
    ref = prog.auto_executor(_port_chain_bodies(
        lambda q, k, v: mha_ref(q[:, None], k[:, None], v[:, None])[:, 0]),
        device="cpu")(packed)
    assert torch.equal(got, ref)


if __name__ == "__main__":
    _write_reference(sys.argv[1])
