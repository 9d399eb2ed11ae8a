"""Tests of the port that need a CUDA GPU: the hand-written kernels (B1
block_gemm, B2 flash_attention, B3 ssd_scan, B4 decode_attention) against
their plain versions on the card, the block executor on the card with B1
and B2 bodies, the host TaskTorrent runtime and the resident scheduler
with block stores on the card (B1 task bodies, AM payloads that stay on
the device), one mamba2 block through B3, the reduced yi-6b through B2
(prefill) and B4 (decode), and the reduced zamba2-1.2b (B2 with a sliding
window, B3, B4 over a ring), seamless-m4t-large-v2 (non-causal B2 with Lq
!= Lk, B4 over the encoder's keys) and llava-next-34b (fed embeddings),
and the moe family: B2 and B4 at grok-1's GQA group of 6, ``moe_ffn``
against ``moe_ref``, the reduced grok-1-314b through B2 and B4 and the
reduced deepseek-v3-671b (MLA: no B2 or B4 launch), prefill against
decode; and training: each of B1-B4 raises on an operand that requires
grad (it has no backward), the prefill attention and the SSD take their
plain versions under grad and the kernels under no_grad, and every
family's reduced loss and gradients on the card equal the CPU's; the
pipeline: B2 launches and bit equality of the pipelined forward, and the
pipelined loss and gradients on the card against the CPU; the block
executor on two rank processes that share the card, with B1; and the
pipelined train step on two stage ranks that share the card, against the
logical step, on the device transport and on gloo; tensor-parallel
serving on two rank processes that share the card, B2 and B4 on each
rank's head shard; and four rank processes mapping each other's device
mailboxes. They skip with a reason where there is no GPU. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import threading

import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_ref,
                                            task_matmul)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_ref, kernel_info)
from repro_torch.kernels.decode_attention.decode_attention import split_plan
from repro_torch.kernels.flash_attention import (flash_attention, mha_ref,
                                                 task_attention)
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunked_ref, ssd_ref,
                                          ssd_scan)
from repro_torch.core import payload_stats, run_ranks, view
from repro_torch.kernels.block_gemm.ops import matmul
from repro_torch.linalg.cholesky import (assemble_lower, cholesky_bodies,
                                         cholesky_executor, cholesky_graph,
                                         cholesky_program, make_spd_blocks)
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.mamba2 import mamba2_forward
from repro_torch.models.transformer import init_params
from repro_torch.ptg import Graph

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max(1, max|plain|): the reference's tolerances;
# f32 sums differ only in order, bf16 by one rounding of an f32 sum
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, dtype, T, m, k, n, transposed, seed=0, a_k=True):
    """A [T, m, k] k- (else m-) contiguous; B [T, k, n] n-contiguous, or
    k-contiguous when ``transposed``: the four f32 instantiations."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = (torch.randn((T, m, k), generator=gen, device=cuda) if a_k else
         torch.randn((T, k, m), generator=gen, device=cuda).mT).to(dtype)
    if transposed:
        return a, torch.randn((T, n, k), generator=gen,
                              device=cuda).to(dtype).mT
    return a, torch.randn((T, k, n), generator=gen, device=cuda).to(dtype)


@pytest.mark.parametrize("T,m,k,n,transposed", [
    (1, 64, 64, 64, False), (1, 128, 96, 64, False), (1, 32, 64, 128, False),
    (1, 256, 128, 256, False), (5, 4, 4, 4, True), (5, 8, 8, 8, True),
    (5, 16, 16, 16, True), (3, 130, 70, 129, True), (2, 512, 512, 512, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, dtype, T, m, k, n, transposed):
    a, b = _operands(cuda, dtype, T, m, k, n, transposed)
    before = block_gemm.launches
    got = block_gemm(a, b)
    want = block_gemm_ref(a, b)
    torch.cuda.synchronize()
    assert block_gemm.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max()
                / max(1.0, float(want.float().abs().max())))
    assert err <= TOL[dtype]


@pytest.mark.parametrize("T,m,k,n", [(3, 130, 70, 129), (4, 131, 37, 67),
                                     (2, 129, 33, 255), (5, 12, 9, 20),
                                     (2, 256, 100, 128)])
@pytest.mark.parametrize("a_k,b_n", [(True, True), (True, False),
                                     (False, True), (False, False)],
                         ids=["Ak-Bn", "Ak-Bk", "Am-Bn", "Am-Bk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_layouts_at_ragged_shapes(cuda, dtype, T, m, k, n, a_k, b_n):
    """Every layout instantiation at ragged M, N and K (K not a multiple of
    the K step), against the plain version, and each task of the batch
    bit for bit equal to the task launched alone."""
    a, b = _operands(cuda, dtype, T, m, k, n, not b_n, seed=m + k + n,
                     a_k=a_k)
    got = block_gemm(a, b)
    want = block_gemm_ref(a, b)
    err = float((got.float() - want.float()).abs().max()
                / max(1.0, float(want.float().abs().max())))
    assert err <= TOL[dtype]
    for i in range(T):
        assert torch.equal(block_gemm(a[i:i + 1], b[i:i + 1])[0], got[i])


def test_kernel_reads_unaligned_operands(cuda):
    """Views one float into a row (no 16-byte copies) take the element
    path of the same kernel."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn((3, 97, 65), generator=gen, device=cuda)
    a = big[:, 1:, 1:]
    b = torch.randn((3, 66, 50), generator=gen, device=cuda)[:, 2:]
    got = block_gemm(a, b)
    assert float((got - block_gemm_ref(a, b)).abs().max()) <= 2e-5 * max(
        1.0, float(block_gemm_ref(a, b).abs().max()))


@pytest.mark.parametrize("a_k,b_n", [(True, True), (True, False),
                                     (False, True), (False, False)])
def test_kernel_info_reports_two_blocks_without_spills(cuda, a_k, b_n):
    from repro_torch.kernels.block_gemm.block_gemm import kernel_info as info
    got = info(a_k, b_n, cuda.index or 0)
    assert got.blocks_per_sm >= 2 and got.spill_bytes == 0
    assert got.registers <= 128 and got.stages >= 3


def test_kernel_result_does_not_depend_on_its_batch(cuda):
    a, b = _operands(cuda, torch.float32, 9, 96, 80, 112, True, seed=1)
    full = block_gemm(a, b)
    for i in range(9):
        assert torch.equal(block_gemm(a[i:i + 1], b[i:i + 1])[0], full[i])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((2, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        block_gemm(a.double(), a.double())
    with pytest.raises(ValueError):
        block_gemm(a, a.cpu())
    with pytest.raises(ValueError):
        block_gemm(a, torch.zeros((2, 5, 4), device=cuda))


def test_cholesky_executor_runs_the_kernel(cuda):
    nb, b = 6, 16
    prog = cholesky_program(nb, 2, 2, b)
    blocks, a = make_spd_blocks(nb, b, seed=0, device=cuda)
    packed = prog.pack(blocks, device=cuda)
    ex = cholesky_executor(prog, matmul=task_matmul, device=cuda)
    block_gemm.launches = 0
    out = ex(packed)
    torch.cuda.synchronize()
    assert block_gemm.launches == ex.calls["syrk"] + ex.calls["gemm"] > 0
    l = assemble_lower(prog.unpack(out), nb, b)
    plain = cholesky_executor(prog, device=cuda)(packed)
    l_plain = assemble_lower(prog.unpack(plain), nb, b)
    assert float((l - l_plain).abs().max()) <= 1e-5
    resid = torch.linalg.vector_norm(l @ l.mT - a) / torch.linalg.vector_norm(a)
    assert float(resid) <= 1e-6


# ------------------------------------------------- host runtime on the card

def test_host_runtime_cholesky_runs_b1_and_matches_compiled(cuda):
    """4 ranks x 2 threads with block stores on the card: one B1 launch per
    syrk/gemm task, no tensor pickled, and the compiled executor's factor
    (same B1 bodies) within the reference's 2e-5."""
    nb, b = 8, 128
    blocks, a = make_spd_blocks(nb, b, seed=0, device=cuda)
    prog = cholesky_program(nb, 2, 2, b)
    comp = assemble_lower(prog.unpack(cholesky_executor(
        prog, matmul=task_matmul, device=cuda)(prog.pack(blocks,
                                                         device=cuda))),
        nb, b)
    block_gemm.launches = 0
    payload_stats.reset()
    out = cholesky_graph(nb, 2, 2, b).run_host(
        blocks, cholesky_bodies(matmul=matmul), device=cuda)
    syrk_gemm = nb * (nb - 1) // 2 + nb * (nb - 1) * (nb - 2) // 6
    assert block_gemm.launches == syrk_gemm
    assert payload_stats.pickled == 0 and payload_stats.copied > 0
    assert all(t.device.type == "cuda" for t in out.values())
    low = assemble_lower(out, nb, b)
    assert _rel(low, comp) <= 2e-5
    resid = torch.linalg.vector_norm(low @ low.mT - a) / \
        torch.linalg.vector_norm(a)
    assert float(resid) <= 1e-6


def test_block_gemm_counts_every_launch_from_eight_threads(cuda):
    a = torch.randn(64, 64, device=cuda)
    matmul(a, a)                      # built and loaded before the threads
    block_gemm.launches = 0

    def work():
        for _ in range(200):
            matmul(a, a.mT)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert block_gemm.launches == 8 * 200


@pytest.mark.parametrize("wrap", ["tensor", "view"])
def test_cuda_payload_stays_on_the_card_and_is_reusable(cuda, wrap):
    def main(ctx):
        got = []
        am = ctx.comm.make_active_msg(lambda t: got.append(t))
        if ctx.rank == 0:
            buf = torch.arange(1024.0, device=cuda)
            am.send(1, view(buf) if wrap == "view" else buf)
            buf.fill_(-1.0)
        ctx.tp.join()
        return got

    payload_stats.reset()
    res = run_ranks(2, main)
    got = res[1][0]
    assert got.device.type == "cuda"
    assert torch.equal(got, torch.arange(1024.0, device=cuda))
    assert payload_stats.pickled == 0 and payload_stats.copied == 1


def test_scheduler_mixed_stream_runs_b1_bit_for_bit(cuda):
    """4 clients x 4 mixed submissions (Task-Bench stencil/fft/tree and a
    Cholesky of 4 x 4 blocks of 128) through the resident scheduler, 4
    ranks with stores on the card: every result bit for bit its one-shot
    ``run_host`` on the card, one B1 launch per syrk/gemm task, no tensor
    pickled, every block on the card."""
    from repro_torch.launch.scheduler import (one_shot_refs, run_stream,
                                              stream_inputs)
    from repro_torch.sched import SchedulerService

    nb = 4
    sizes = dict(width=8, depth=4, nb=nb, b=128, tb_b=128)
    matmul(torch.ones(8, 8, device=cuda), torch.ones(8, 8, device=cuda))
    with SchedulerService(4, device=cuda) as svc:
        inputs = stream_inputs(cuda, **sizes)
        block_gemm.launches = 0
        payload_stats.reset()
        results = run_stream(svc, 4, 4, inputs=inputs, **sizes)
        launches = block_gemm.launches
    syrk_gemm = nb * (nb - 1) // 2 + nb * (nb - 1) * (nb - 2) // 6
    assert launches == 4 * syrk_gemm
    assert payload_stats.pickled == 0 and payload_stats.copied > 0
    refs = one_shot_refs(svc, {"stencil", "fft", "tree", "cholesky"},
                         inputs=inputs, **sizes)
    for rows in results.values():
        assert [k for k, _ in rows] == ["stencil", "fft", "tree",
                                        "cholesky"]
        for kind, out in rows:
            for blk, v in out.items():
                assert v.is_cuda and torch.equal(v, refs[kind][blk]), \
                    (kind, blk)
    stats = svc.stats()
    assert all(r["tasks_live"] == 0 for r in stats["ranks"])
    assert stats["live_frac"] < 1.0


def test_scheduler_chained_stream_survives_a_killed_rank(cuda):
    """A stencil stream chained through one namespace, with rank 1 killed
    at its 12th AM: bit for bit the fault-free stream on the card."""
    from repro_torch.core import FaultPlan
    from repro_torch.sched import SchedulerService
    from repro_torch.taskbench import (taskbench_blocks, taskbench_bodies,
                                       taskbench_graph)

    g, _ = taskbench_graph("stencil", 8, 6, 4, 64, seed=3)
    blocks = {k: torch.as_tensor(v, device=cuda)
              for k, v in taskbench_blocks(8, 6, 64, seed=3).items()}
    outs = {}
    for label, plan in (("clean", None), ("kill", FaultPlan(
            seed=3, kill={1: 12}, lease=0.4, heartbeat_every=0.02))):
        with SchedulerService(4, timeout=120.0, faults=plan,
                              device=cuda) as svc:
            c = svc.client("chain")
            futs = [c.submit(g, blocks if j == 0 else {},
                             taskbench_bodies()) for j in range(6)]
            outs[label] = [f.result(120.0) for f in futs]
    assert svc.recovery_report.deaths == [1]
    for got, want in zip(outs["kill"], outs["clean"]):
        assert got.keys() == want.keys()
        assert all(got[k].is_cuda and torch.equal(got[k], want[k])
                   for k in want)


# ------------------------------------------------------ flash attention (B2)

# B2 and B3 against their plain versions, same measure. B2 takes TOL (the
# reference's 2e-5 / 2e-2: sums and the online softmax's rescaling in
# another order; one bf16 rounding). B3 in f32: the reference's 2e-4 (exp
# of cumulative sums in another order); in bf16 both sides load the same
# bf16 values and round y once, and the kernel rounds its tensor-core
# operands (scores, scaled x, chunk states) to bf16: the reference's 2e-2.
TOL_SSD = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# B3 per (batch, head), against the head's own size, as chip_smoke.py holds
# it (scripts/torch_ssd_rounding.py measures the rounding: 5.7e-7 in f32,
# 7.3e-3 in bf16 at mamba2-1.3b's layer).
SSD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _head_rel(got, want):
    """Largest over (batch, q head) of max|got - want| / max|want| within
    that head's [L, D]: each head held to its own size."""
    got, want = got.float().flatten(2), want.float().flatten(2)
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max())


def _ssd_head_rel(got, want):
    """``_head_rel`` over B3's [B, L, H, P]: per (batch, head)."""
    return _head_rel(got.transpose(1, 2), want.transpose(1, 2))


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 256, 32),
    (1, 2, 2, 256, 256, 128), (1, 2, 2, 512, 512, 64), (3, 1, 1, 32, 32, 16),
    (1, 2, 1, 37, 100, 48), (2, 4, 2, 100, 100, 80), (1, 1, 1, 1, 1, 8),
    (1, 3, 3, 65, 65, 128), (1, 2, 2, 1000, 1000, 128),
    (1, 2, 2, 1000, 3000, 128),
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, dtype, causal, b, hq, hkv, lq,
                                       lk, d):
    gen = torch.Generator(device=cuda).manual_seed(lq * 7 + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]
    assert _head_rel(got, want) <= TOL[dtype]


def test_flash_attention_reads_strided_operands(cuda):
    """q, k, v as views with a padded head dim and swapped axes: the kernel
    reads them through their strides, with no copy."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn((2, 64, 4, 40), generator=gen, device=cuda)
    q = base[..., :32].transpose(1, 2)             # [2, 4, 64, 32]
    k = torch.randn((2, 64, 2, 32), generator=gen, device=cuda).transpose(1, 2)
    v = torch.randn((2, 2, 64, 32), generator=gen, device=cuda)
    assert not q.is_contiguous() and not k.is_contiguous()
    err = _rel(flash_attention(q, k, v), mha_ref(q, k, v))
    assert err <= TOL[torch.float32]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_reads_the_model_layout(cuda, dtype, d):
    """q, k, v as the dense model hands them over (``transformer.py``:
    [B, S, H, D] projections viewed as [B, H, S, D], v never made
    contiguous), GQA 8 over 2: read in place (no copy for TMA), right on
    the whole tensor and per (batch, q head)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, 300, h, d), generator=gen,
                           device=cuda).to(dtype).transpose(1, 2)
               for h in (8, 2, 2))
    assert not v.is_contiguous()
    copies = flash_attention.copies
    got = flash_attention(q, k, v)
    want = mha_ref(q, k, v)
    assert flash_attention.copies == copies
    assert _rel(got, want) <= TOL[dtype]
    assert _head_rel(got, want) <= TOL[dtype]


def test_flash_attention_copies_what_tma_cannot_read(cuda):
    """bf16 rows of 37 values (74 bytes) and a column stride of 2: TMA
    cannot read them, so the wrapper copies each such operand (counted)
    and the kernel still runs on the tensor cores."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((1, 4, 70, 37), generator=gen, device=cuda).bfloat16()
    kv = torch.randn((1, 2, 70, 74), generator=gen, device=cuda).bfloat16()
    k, v = kv[..., ::2], kv[..., 1::2]
    copies, launches = flash_attention.copies, flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.copies == copies + 3
    assert flash_attention.launches == launches + 1
    assert _rel(got, mha_ref(q, k, v)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_task_attention_does_not_depend_on_its_batch(cuda, causal):
    """The f32 split plan depends on the task's shape only, so a chain
    task's result is the same, bit for bit, in a batch of 3 as alone."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((3, 4096, 128), generator=gen, device=cuda)
               for _ in range(3))
    batched = task_attention(q, k, v, causal=causal)
    for t in range(3):
        alone = task_attention(q[t:t + 1], k[t:t + 1], v[t:t + 1],
                               causal=causal)
        assert torch.equal(batched[t:t + 1], alone), t


def test_attention_chains_are_bit_identical_under_every_policy(cuda):
    """Four chains of task_attention bodies (seq 512, dim 64, depth 5, 2
    shards): each lowering batches the tasks differently (the dense scan
    and the union cover pad the batches), and every one gives the same
    blocks, bit for bit."""
    width, depth, seq, dim, n_sh = 4, 5, 512, 64, 2
    g = Graph("attnchains", n_shards=n_sh, owner=lambda blk: blk[1] % n_sh,
              block_shape=(seq, dim))
    g.task_type("src", space=lambda: ((c,) for c in range(width)),
                writes=lambda c: ("x", c, 0), reads=lambda c: [("in", c)])
    g.task_type("attn", space=lambda: ((c, l) for c in range(width)
                                       for l in range(1, depth + 1)),
                writes=lambda c, l: ("x", c, l),
                reads=lambda c, l: [("x", c, l - 1)] * 3)
    prog = g.to_program()
    gen = torch.Generator(device=cuda).manual_seed(3)
    blocks = {}
    for c in range(width):
        blocks[("in", c)] = torch.randn((seq, dim), generator=gen,
                                        device=cuda)
        for l in range(depth + 1):
            blocks[("x", c, l)] = torch.zeros((seq, dim), device=cuda)
    packed = prog.pack(blocks, device=cuda)
    bodies = {"src": lambda x: x, "attn": task_attention}
    runs = {"auto": prog.auto_executor(bodies, device=cuda)}
    for name, kw in (("unrolled", dict(scan=False)), ("scan", dict(scan=True)),
                     ("union", dict(scan=True, comm="auto",
                                    cover="union"))):
        runs[name] = prog.executor(bodies, device=cuda, **kw)
    outs = {name: ex(packed) for name, ex in runs.items()}
    ref = outs.pop("unrolled")
    slots = list(prog.slot_of.values())
    for name, out in outs.items():
        for s, slot in slots:
            assert torch.equal(out[s, slot], ref[s, slot]), (name, s, slot)


def test_task_attention_under_the_executor(cuda):
    """The attention-chain PTG (depth 6, seq 32, dim 16, 2 shards) with
    ``task_attention`` bodies: one launch per executor attn call, and the
    result of ``mha_ref`` bodies on the card."""
    depth, seq, dim, n_sh = 6, 32, 16, 2
    g = Graph("attnchain", n_shards=n_sh, owner=lambda blk: blk[1] % n_sh,
              block_shape=(seq, dim))
    g.task_type("src", space=lambda: ((0,),), writes=lambda l: ("x", 0),
                reads=lambda l: [("in", 0)])
    g.task_type("attn", space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l), reads=lambda l: [("x", l - 1)] * 3)
    prog = g.to_program()
    gen = torch.Generator(device=cuda).manual_seed(7)
    blocks = {("in", 0): torch.randn((seq, dim), generator=gen, device=cuda)}
    for l in range(depth + 1):
        blocks[("x", l)] = torch.zeros((seq, dim), device=cuda)
    packed = prog.pack(blocks, device=cuda)
    ex = prog.auto_executor({"src": lambda x: x, "attn": task_attention},
                            device=cuda)
    flash_attention.launches = 0
    got = ex(packed)
    torch.cuda.synchronize()
    assert flash_attention.launches == ex.calls["attn"] == depth
    plain = prog.auto_executor(
        {"src": lambda x: x,
         "attn": lambda q, k, v: mha_ref(q[:, None], k[:, None],
                                         v[:, None])[:, 0]},
        device=cuda)(packed)
    assert _rel(got, plain) <= TOL[torch.float32]


# ------------------------------------------------------------ SSD scan (B3)

def _ssd_inputs(cuda, dtype, b, l, h, g, p, n, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda)

    x = randn(b, l, h, p).to(dtype)
    dt = (torch.nn.functional.softplus(randn(b, l, h)) * 0.1).to(dtype)
    a = -torch.exp(randn(h) * 0.5)
    bm = (randn(b, l, g, n) * 0.5).to(dtype)
    cm = (randn(b, l, g, n) * 0.5).to(dtype)
    d = torch.full((h,), 0.5, device=cuda)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("b,l,h,g,p,n,q", [
    (1, 128, 2, 1, 32, 16, 64), (2, 256, 4, 2, 64, 32, 128),
    (1, 64, 8, 8, 16, 16, 32), (1, 256, 2, 1, 16, 8, 32),
    (1, 256, 4, 1, 64, 128, 128), (2, 96, 4, 2, 80, 24, 48),
    (1, 48, 2, 1, 8, 4, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda, dtype, b, l, h, g, p, n, q):
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, dtype, b, l, h, g, p, n)
    before = ssd_scan.launches
    got = ssd_scan(x, dt, a, bm, cm, d, q_chunk=q)
    want = ssd_chunked_ref(x, dt, a, bm, cm, d, q_chunk=q)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL_SSD[dtype]
    no_skip = ssd_scan(x, dt, a, bm, cm, None, q_chunk=q)
    assert _rel(no_skip, ssd_chunked_ref(x, dt, a, bm, cm, None,
                                         q_chunk=q)) <= TOL_SSD[dtype]


@pytest.mark.parametrize("l,q", [(100, 32), (200, 128), (7, 4)])
def test_ssd_scan_masks_a_ragged_last_chunk(cuda, l, q):
    """L not a multiple of Q: the kernel masks the last chunk and matches
    the token recurrence (the chunked plain version refuses such L)."""
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, torch.float32, 2, l, 4, 2, 16, 8,
                                      seed=l)
    got = ssd(x, dt, a, bm, cm, d, q_chunk=q)
    assert _rel(got, ssd_ref(x, dt, a, bm, cm, d)) <= TOL_SSD[torch.float32]


def test_ssd_scan_reads_strided_views(cuda):
    """x, B and C as views of one wider projection (the model's layout)."""
    b, l, h, p, g, n = 2, 128, 4, 16, 1, 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    proj = torch.randn((b, l, h * p + 2 * g * n + 5), generator=gen,
                       device=cuda) * 0.5
    x = proj[..., :h * p].unflatten(-1, (h, p))
    bm = proj[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = proj[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen,
                                                  device=cuda)) * 0.1
    a = -torch.ones(h, device=cuda)
    assert not x.is_contiguous() and not bm.is_contiguous()
    got = ssd_scan(x, dt, a, bm, cm, None, q_chunk=64)
    want = ssd_chunked_ref(x, dt, a, bm, cm, None, q_chunk=64)
    assert _rel(got, want) <= TOL_SSD[torch.float32]


def _mamba2_block(cuda, cfg, length):
    """(kernel on the card, plain on the CPU) outputs of one mamba2 block of
    ``cfg``, f32 compute, over a [2, length] sequence; asserts one B3
    launch and no element-wise copies of its strided x, B and C."""
    params = init_params(cfg, seed=0, device="cpu")
    layer = {k: v[0] for k, v in params["ssm"]["mamba"].items()}
    x = torch.randn((2, length, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = mamba2_forward(x, layer, cfg.ssm)
    layer_c = {k: v.to(cuda) for k, v in layer.items()}
    before, narrow = ssd_scan.launches, ssd_scan.narrow
    got = mamba2_forward(x.to(cuda), layer_c, cfg.ssm)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert ssd_scan.narrow == narrow
    return got.cpu(), want


def test_mamba2_block_runs_the_ssd_kernel(cuda):
    """One reduced mamba2-1.3b block on the card (one B3 launch) against the
    same block on the CPU (the plain version), f32 compute."""
    cfg = reduced(get_config("mamba2-1.3b"), compute_dtype="float32")
    got, want = _mamba2_block(cuda, cfg, 64)
    assert _rel(got, want) <= TOL_SSD[torch.float32]


def test_mamba2_block_with_chunks_of_256(cuda, monkeypatch):
    """Fault C1 on the model path: with REPRO_SSD_CHUNK=256 and mamba2-1.3b's
    d_state of 128 the block runs B3 (which once refused the chunk for its
    shared memory) and matches the plain version."""
    monkeypatch.setenv("REPRO_SSD_CHUNK", "256")
    cfg = reduced(get_config("mamba2-1.3b"), compute_dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           d_state=128))
    got, want = _mamba2_block(cuda, cfg, 512)
    assert _rel(got, want) <= TOL_SSD[torch.float32]


@pytest.mark.parametrize("q,l", [(256, 1024), (512, 1024), (256, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_long_chunks(cuda, dtype, q, l):
    """Fault C1: chunks of 256 and 512 at d_state 128 (the reference takes
    any Q that tiles L), a ragged one too; whole and per (batch, head)."""
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, dtype, 2, l, 4, 2, 64, 128,
                                      seed=q)
    got = ssd_scan(x, dt, a, bm, cm, d, q_chunk=q)
    want = (ssd_chunked_ref(x, dt, a, bm, cm, d, q_chunk=q) if l % q == 0
            else ssd_ref(x, dt, a, bm, cm, d))
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL_SSD[dtype]
    assert _ssd_head_rel(got, want) <= SSD_ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_per_head_at_the_model_layer(cuda, dtype):
    """mamba2-1.3b's layer at prefill (B 4, L 2048, H 64, P 64, N 128) in
    the model's layout: each (batch, head) against its own size, and no
    element-wise copies."""
    b, l, h, p, g, n = 4, 2048, 64, 64, 1, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    proj = (torch.randn((b, l, h * p + 2 * g * n), generator=gen,
                        device=cuda) * 0.5).to(dtype)
    x, bm, cm = proj.split([h * p, g * n, g * n], dim=-1)
    x, bm, cm = (x.unflatten(-1, (h, p)), bm.unflatten(-1, (g, n)),
                 cm.unflatten(-1, (g, n)))
    dt = (torch.nn.functional.softplus(torch.randn(
        (b, l, h), generator=gen, device=cuda)) * 0.1).to(dtype)
    a = -torch.exp(torch.randn(h, generator=gen, device=cuda) * 0.5)
    d = torch.full((h,), 0.5, device=cuda)
    narrow = ssd_scan.narrow
    got = ssd_scan(x, dt, a, bm, cm, d)
    want = ssd_chunked_ref(x, dt, a, bm, cm, d)
    torch.cuda.synchronize()
    assert ssd_scan.narrow == narrow
    assert _rel(got, want) <= TOL_SSD[dtype]
    assert _ssd_head_rel(got, want) <= SSD_ROW_TOL[dtype]


def test_ssd_scan_counts_element_wise_copies(cuda):
    """``ssd_scan.narrow`` counts a call whose x, B or C rows cannot be
    copied 16 bytes at a time (a projection 5 elements wider than its
    pieces), and not one of contiguous operands."""
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, torch.bfloat16, 2, 128, 4, 1, 16,
                                      32)
    narrow = ssd_scan.narrow
    ssd_scan(x, dt, a, bm, cm, d, q_chunk=64)
    assert ssd_scan.narrow == narrow
    proj = torch.cat([x.flatten(2), bm.flatten(2), cm.flatten(2),
                      torch.zeros_like(x.flatten(2)[..., :5])], dim=-1)
    xv = proj[..., :64].unflatten(-1, (4, 16))
    bv = proj[..., 64:96].unflatten(-1, (1, 32))
    cv = proj[..., 96:128].unflatten(-1, (1, 32))
    got = ssd_scan(xv, dt, a, bv, cv, d, q_chunk=64)
    torch.cuda.synchronize()
    assert ssd_scan.narrow == narrow + 1
    assert _rel(got, ssd_chunked_ref(x, dt, a, bm, cm, d, q_chunk=64)) \
        <= TOL_SSD[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_head_independent_of_batch(cuda, dtype):
    """A batch row's result is the same, bit for bit, whether it runs
    with others or alone (no block's work depends on the batch)."""
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, dtype, 3, 512, 4, 2, 64, 128)
    batched = ssd_scan(x, dt, a, bm, cm, d)
    for i in range(3):
        alone = ssd_scan(x[i:i + 1], dt[i:i + 1], a, bm[i:i + 1],
                         cm[i:i + 1], d)
        assert torch.equal(alone[0], batched[i])


# ------------------------------------------------------ decode attention (B4)

# B4 per (batch, q head) row against the row's own size, as chip_smoke.py
# holds it (scripts/torch_decode_rounding.py measures the rounding).
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _row_rel(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max())


@pytest.mark.parametrize("b,hq,hkv,s,d,ragged", [
    (2, 8, 2, 256, 64, False), (1, 4, 4, 512, 128, False),
    (4, 16, 1, 128, 64, False),                 # tests/test_kernels.py
    (3, 4, 2, 256, 64, True), (2, 8, 2, 200, 64, True),   # ragged S
    (2, 12, 2, 300, 80, True), (1, 40, 8, 1000, 128, True),
    (2, 24, 2, 513, 128, True), (1, 1, 1, 1, 8, False),
    (2, 4, 4, 70, 20, True), (8, 32, 4, 4096, 128, True),  # yi-6b's layer
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_matches_plain(cuda, dtype, b, hq, hkv, s, d,
                                        ragged):
    gen = torch.Generator(device=cuda).manual_seed(s * 3 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
    kv_len = None
    if ragged:
        kv_len = torch.randint(1, s + 1, (b,), generator=gen, device=cuda,
                               dtype=torch.int32)
        kv_len[0] = s
        kv_len[-1] = 1 if b > 1 else kv_len[-1]
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]
    assert _row_rel(got, want) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_plans_one_wave_of_resident_blocks(cuda, dtype):
    info = kernel_info(dtype, 128, True, cuda.index or 0)
    blocks = info.blocks_per_sm
    # the blocks' shared memory fits an SM's 228 KB; bf16's ring keeps at
    # least 48 KB of K and V in flight on an SM, without spills
    assert 1 <= blocks and blocks * info.smem_bytes <= 228 * 1024
    assert info.registers > 0 and info.spill_bytes >= 0
    if dtype == torch.bfloat16:
        in_flight = (info.stages - 1) * 2 * info.ts * 128 * 2 * blocks
        assert in_flight >= 48 * 1024 and info.spill_bytes == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, n_split = split_plan(32768, 32, sms * blocks, info.ts)  # batch 8
    assert 32 * n_split <= sms * blocks < 2 * 32 * n_split


@pytest.mark.parametrize("lens", [
    (63, 65, 127, 129, 255, 257, 383, 385),          # tile +-1, stage +-1
    (1151, 1153, 1279, 1281, 1023, 1025, 1, 4096),   # the same a range in
])
def test_decode_attention_bf16_ring_ends_mid_stage(cuda, lens):
    """bf16 at yi-6b's head layout over 4096 positions: ranges of 1024 or
    more positions (several tiles and turns of the ring), kv_len ending one
    short of and one past a tile (64 or 128 positions) and a turn of the
    ring, in the first range and one range in; none of it goes to the
    CUDA-core kernel."""
    gen = torch.Generator(device=cuda).manual_seed(sum(lens))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
               for shape in ((8, 32, 128), (8, 4, 4096, 128),
                             (8, 4, 4096, 128)))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    decode_attention.narrow = 0
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    assert decode_attention.narrow == 0
    assert _rel(got, want) <= TOL[torch.bfloat16]
    assert _row_rel(got, want) <= ROW_TOL[torch.bfloat16]


def test_decode_attention_counts_the_layouts_the_ring_cannot_read(cuda):
    """bf16 with D = 20, a view one element into the rows, or K with D not
    contiguous runs on the CUDA-core kernel and is counted; f32 is never
    counted, the model's layout never."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    kv_len = torch.tensor([70, 3], dtype=torch.int32, device=cuda)

    def run(q, k, v):
        before = decode_attention.narrow
        got = decode_attention(q, k, v, kv_len)
        assert _rel(got, decode_ref(q, k, v, kv_len)) <= TOL[q.dtype]
        return decode_attention.narrow - before

    q20, k20, v20 = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
                     for shape in ((2, 4, 20), (2, 2, 70, 20), (2, 2, 70, 20)))
    assert run(q20, k20, v20) == 1
    big = torch.randn((2, 2, 70, 72), generator=gen, device=cuda).bfloat16()
    q = torch.randn((2, 4, 64), generator=gen, device=cuda).bfloat16()
    assert run(q, big[..., 1:65], big[..., 8:72]) == 1
    assert run(q, big[..., 8:72].transpose(2, 3).contiguous().transpose(2, 3),
               big[..., 8:72]) == 1
    assert run(q, big[..., 8:72], big[..., 0:64]) == 0
    assert run(q.float(), big[..., 1:65].float(), big[..., 8:72].float()) == 0


def test_decode_attention_reference_ragged_lengths(cuda):
    """``tests/test_kernels.py``'s ragged case: kv_len [256, 100, 17]."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((3, 4, 64), (3, 2, 256, 64), (3, 2, 256, 64)))
    kv_len = torch.tensor([256, 100, 17], dtype=torch.int32, device=cuda)
    assert _rel(decode_attention(q, k, v, kv_len),
                decode_ref(q, k, v, kv_len)) <= TOL[torch.float32]
    # kv_len past S reads as S; int64 lengths are taken
    past = torch.tensor([900, 100, 17], device=cuda)
    assert torch.equal(decode_attention(q, k, v, past),
                       decode_attention(q, k, v, kv_len))


def test_decode_attention_reads_a_cache_with_replicated_heads(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((2, 8, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 2, 333, 128), generator=gen, device=cuda)
            for _ in range(2))
    kv_len = torch.tensor([333, 45], dtype=torch.int32, device=cuda)
    kp, vp = (t.repeat_interleave(2, dim=1) for t in (k, v))
    got = decode_attention(q, kp, vp, kv_len)
    assert _rel(got, decode_ref(q, kp, vp, kv_len)) <= TOL[torch.float32]
    assert _rel(got, decode_ref(q, k, v, kv_len)) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_reads_strided_views(cuda, dtype):
    """A cache window (16-byte rows, the vector loads) and views whose head
    dim is not contiguous (element loads), with a strided q."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randn((2, 3, 500, 64), generator=gen, device=cuda).to(dtype)
    k, v = big[:, :2, 100:400], big[:, 1:, 50:350]
    q = torch.randn((2, 4, 96), generator=gen, device=cuda).to(dtype)[..., :64]
    kv_len = torch.tensor([300, 77], dtype=torch.int32, device=cuda)
    assert not k.is_contiguous() and not q.is_contiguous()
    assert _rel(decode_attention(q, k, v, kv_len),
                decode_ref(q, k, v, kv_len)) <= TOL[dtype]
    kt = torch.randn((2, 2, 64, 300), generator=gen,
                     device=cuda).to(dtype).transpose(2, 3)
    assert kt.stride(3) != 1
    assert _rel(decode_attention(q, kt, v, kv_len),
                decode_ref(q, kt, v, kv_len)) <= TOL[dtype]


def test_decode_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 4, 64), device=cuda)
    k = torch.zeros((2, 2, 16, 64), device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError):
        decode_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        decode_attention(q, k.cpu(), k.cpu())
    with pytest.raises(ValueError):
        decode_attention(q, k, k, torch.tensor([16, 16]))       # on the CPU
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros((2, 3, 16, 64), device=cuda),
                         torch.zeros((2, 3, 16, 64), device=cuda))
    with pytest.raises(ValueError):
        decode_attention(torch.zeros((2, 4, 256), device=cuda),
                         torch.zeros((2, 2, 16, 256), device=cuda),
                         torch.zeros((2, 2, 16, 256), device=cuda))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("kv_head_pad", [1, 2])
def test_dense_model_runs_flash_and_decode_kernels(cuda, kv_head_pad):
    """The reduced yi-6b on the card, f32 compute: a prefill launches B2 once
    per layer and each decode step B4 once per layer; logits against the
    same steps on the CPU (the plain versions). Tolerance 1e-4 of
    max|logits|, as the CPU parity tests: the same f32 function with sums
    in other orders over two layers."""
    cfg = reduced(get_config("yi-6b"), compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    params_c = _to(params, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    flash_attention.launches = 0
    got = tfm.prefill(cfg, params_c, tokens=toks.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.n_layers
    want = tfm.prefill(cfg, params, tokens=toks)
    assert _rel(got.cpu(), want) <= 1e-4
    caches = [tfm.init_cache(cfg, 2, 48, dtype=torch.float32, device=dev,
                             kv_head_pad=kv_head_pad)
              for dev in (cuda, "cpu")]
    for t in range(toks.shape[1]):
        decode_attention.launches = 0
        got, caches[0] = tfm.decode_step(cfg, params_c, toks[:, t].to(cuda),
                                         caches[0])
        assert decode_attention.launches == cfg.n_layers
        want, caches[1] = tfm.decode_step(cfg, params, toks[:, t], caches[1])
        assert _rel(got.cpu(), want) <= 1e-4, t


# ----------------------------------- the hybrid, encdec and vlm families' shapes

@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,window", [
    (1, 4, 4, 1024, 1024, 64, 1), (1, 4, 4, 1024, 1024, 64, 64),
    (2, 8, 8, 1000, 1000, 64, 300), (1, 14, 2, 700, 900, 128, 129),
    (1, 2, 2, 777, 777, 128, 777), (1, 2, 2, 300, 300, 64, 5000),
    (1, 4, 4, 4608, 4608, 64, 4096), (1, 2, 2, 8192, 8192, 64, 4096),
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_window_matches_plain(cuda, dtype, causal, b, hq,
                                              hkv, lq, lk, d, window):
    """B2 with a sliding window (zamba2's shared block: window 4 096 over
    8 192 keys, head dim 64, group 1; and windows of 1, of a tile and off
    the tiles, GQA 7, Lq < Lk, a window of Lk or more) against ``mha_ref``
    with the window, whole and per (batch, q head)."""
    gen = torch.Generator(device=cuda).manual_seed(lq + window)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = mha_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _rel(got, want) <= TOL[dtype]
    assert _head_rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (4, 16, 16, 512, 2048, 64),      # seamless's cross-attention
    (2, 4, 4, 2048, 512, 64),        # Lq > Lk
    (1, 14, 2, 300, 1000, 128), (1, 4, 4, 1000, 77, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_full_with_lq_not_lk(cuda, dtype, b, hq, hkv, lq,
                                             lk, d):
    """Non-causal B2 with Lq != Lk (queries over another sequence's keys):
    no mask whatever Lk - Lq, in the model's strided layout, no copy."""
    gen = torch.Generator(device=cuda).manual_seed(lq * 3 + lk)
    q = torch.randn((b, lq, hq, d), generator=gen,
                    device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, lk, hkv, d), generator=gen,
                        device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    copies = flash_attention.copies
    got = flash_attention(q, k, v, causal=False)
    want = mha_ref(q, k, v, causal=False)
    assert flash_attention.copies == copies
    assert _rel(got, want) <= TOL[dtype]
    assert _head_rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_at_d_state_64(cuda, dtype):
    """B3 at zamba2-1.2b's layer (H 64, P 64, one group, N 64; L cut to
    1 024) in the model's layout: whole and per (batch, head), no
    element-wise copies."""
    b, l, h, p, g, n = 2, 1024, 64, 64, 1, 64
    gen = torch.Generator(device=cuda).manual_seed(64)
    proj = (torch.randn((b, l, h * p + 2 * g * n), generator=gen,
                        device=cuda) * 0.5).to(dtype)
    x, bm, cm = proj.split([h * p, g * n, g * n], dim=-1)
    x, bm, cm = (x.unflatten(-1, (h, p)), bm.unflatten(-1, (g, n)),
                 cm.unflatten(-1, (g, n)))
    dt = (torch.nn.functional.softplus(torch.randn(
        (b, l, h), generator=gen, device=cuda)) * 0.1).to(dtype)
    a = -torch.exp(torch.randn(h, generator=gen, device=cuda) * 0.5)
    d = torch.full((h,), 0.5, device=cuda)
    narrow = ssd_scan.narrow
    got = ssd_scan(x, dt, a, bm, cm, d, q_chunk=128)
    want = ssd_chunked_ref(x, dt, a, bm, cm, d, q_chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan.narrow == narrow
    assert _rel(got, want) <= TOL_SSD[dtype]
    assert _ssd_head_rel(got, want) <= SSD_ROW_TOL[dtype]


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (8, 32, 32, 4096, 64),       # zamba2's ring, group 1
    (4, 16, 16, 2048, 64),       # seamless's cross-attention
    (8, 56, 8, 1000, 128),       # llava's group 7
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_groups_1_and_7(cuda, dtype, b, hq, hkv, s, d):
    """B4 at one q head per KV head (D 64) and at 7: ragged lengths, whole
    and per row; bf16 of these layouts stays on the ring kernel."""
    gen = torch.Generator(device=cuda).manual_seed(hq + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
    kv_len = torch.randint(1, s + 1, (b,), generator=gen, device=cuda,
                           dtype=torch.int32)
    kv_len[0] = s
    narrow = decode_attention.narrow
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    assert decode_attention.narrow == narrow
    assert _rel(got, want) <= TOL[dtype]
    assert _row_rel(got, want) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_reads_a_ring_in_any_order(cuda, dtype):
    """A wrapped ring (zamba2's 4 096 slots at a position past the wrap)
    holds the window's keys out of order; B4's result is the plain
    attention over the same keys in order."""
    b, h, s, d = 4, 32, 4096, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, d), (b, h, s, d), (b, h, s, d)))
    pos = 3 * s + 1234                 # the ring's slot of position p: p % s
    order = (torch.arange(pos - s + 1, pos + 1, device=cuda)) % s
    got = decode_attention(q, k, v)
    want = decode_ref(q, k[:, :, order], v[:, :, order])
    assert _rel(got, want) <= TOL[dtype]
    assert _row_rel(got, want) <= ROW_TOL[dtype]


def _model_on_both(cuda, cfg, prefill_kw, n_steps, max_seq, enc_out=None):
    """Prefill on the card and on the CPU, then ``n_steps`` decode steps
    from ``init_cache`` on each (f32 compute); returns the B2 launches of
    the prefill, the B4 launches of each step, and the worst relative
    difference of the logits."""
    params = init_params(cfg, seed=0, device="cpu")
    params_c = _to(params, cuda)
    flash_attention.launches = 0
    got = tfm.prefill(cfg, params_c, **{k: v.to(cuda)
                                        for k, v in prefill_kw.items()})
    torch.cuda.synchronize()
    b2 = flash_attention.launches
    errs = [_rel(got.cpu(), tfm.prefill(cfg, params, **prefill_kw))]
    toks = torch.randint(0, cfg.vocab_size, (2, n_steps),
                         generator=torch.Generator().manual_seed(3))
    caches = [tfm.init_cache(cfg, 2, max_seq, dtype=torch.float32,
                             device=dev, enc_out=None if enc_out is None
                             else tuple(t.to(dev) for t in enc_out))
              for dev in (cuda, "cpu")]
    b4 = []
    for t in range(n_steps):
        decode_attention.launches = 0
        got, caches[0] = tfm.decode_step(cfg, params_c, toks[:, t].to(cuda),
                                         caches[0])
        b4.append(decode_attention.launches)
        want, caches[1] = tfm.decode_step(cfg, params, toks[:, t], caches[1])
        errs.append(_rel(got.cpu(), want))
    return b2, b4, max(errs)


def test_hybrid_model_runs_windowed_kernels(cuda):
    """The reduced zamba2-1.2b with 5 layers (two shared sites) and window
    16, f32 compute: prefill of 40 tokens launches B2 (windowed) once per
    site and B3 once per Mamba-2 layer; 40 decode steps over 16-slot rings
    launch B4 once per site a step; logits as on the CPU to 1e-4."""
    cfg = reduced(get_config("zamba2-1.2b"), compute_dtype="float32",
                  sliding_window=16, n_layers=5)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    ssd_scan.launches = 0
    b2, b4, err = _model_on_both(cuda, cfg, {"tokens": toks}, 40, 64)
    assert b2 == 2 and ssd_scan.launches == cfg.n_layers
    assert b4 == [2] * 40
    assert err <= 1e-4


def test_encdec_model_runs_cross_attention_kernels(cuda):
    """The reduced seamless-m4t-large-v2, f32 compute: a prefill over 48
    frame embeddings and 16 tokens launches B2 once per encoder layer and
    twice per decoder layer (self, then cross with Lq != Lk); decode steps
    over a cross cache launch B4 twice per decoder layer a step; logits as
    on the CPU to 1e-4."""
    cfg = reduced(get_config("seamless-m4t-large-v2"),
                  compute_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    kw = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen),
          "enc_embeds": torch.randn((2, 48, cfg.d_model), generator=gen)}
    enc_out = tuple(torch.randn((cfg.n_layers, 2, cfg.n_kv_heads, 48,
                                 cfg.head_dim), generator=gen)
                    for _ in range(2))
    b2, b4, err = _model_on_both(cuda, cfg, kw, 8, 16, enc_out=enc_out)
    assert b2 == cfg.encoder_layers + 2 * cfg.n_layers
    assert b4 == [2 * cfg.n_layers] * 8
    assert err <= 1e-4


def test_vlm_model_runs_from_embeds(cuda):
    """The reduced llava-next-34b, f32 compute, prefill from embeddings:
    B2 once per layer, B4 once per layer a step, logits as on the CPU."""
    cfg = reduced(get_config("llava-next-34b"), compute_dtype="float32")
    emb = torch.randn((2, 40, cfg.d_model),
                      generator=torch.Generator().manual_seed(5))
    b2, b4, err = _model_on_both(cuda, cfg, {"embeds": emb}, 8, 48)
    assert b2 == cfg.n_layers and b4 == [cfg.n_layers] * 8
    assert err <= 1e-4


# ------------------------------------------------------------ the moe family

@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (2, 48, 8, 1024, 1024, 128),     # grok-1's heads
    (1, 12, 2, 1000, 1000, 128), (2, 6, 1, 300, 777, 64),
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_at_group_6(cuda, dtype, causal, b, hq, hkv, lq, lk,
                                    d):
    """B2 with six q heads over each KV head (grok-1-314b: 48 over 8), in
    the model's strided layout, ragged L, Lq < Lk: whole and per (batch,
    q head), no copy."""
    gen = torch.Generator(device=cuda).manual_seed(hq * lq + lk)
    q = torch.randn((b, lq, hq, d), generator=gen,
                    device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, lk, hkv, d), generator=gen,
                        device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    copies = flash_attention.copies
    got = flash_attention(q, k, v, causal=causal)
    want = mha_ref(q, k, v, causal=causal)
    assert flash_attention.copies == copies
    assert _rel(got, want) <= TOL[dtype]
    assert _head_rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (8, 48, 8, 4096, 128),       # grok-1's decode layer
    (2, 12, 2, 1000, 128), (3, 6, 1, 333, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_decode_attention_at_group_6(cuda, dtype, b, hq, hkv, s, d):
    """B4 at six q heads per KV head: ragged lengths, whole and per row;
    bf16 stays on the ring kernel."""
    gen = torch.Generator(device=cuda).manual_seed(hq + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
    kv_len = torch.randint(1, s + 1, (b,), generator=gen, device=cuda,
                           dtype=torch.int32)
    kv_len[0] = s
    narrow = decode_attention.narrow
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    assert decode_attention.narrow == narrow
    assert _rel(got, want) <= TOL[dtype]
    assert _row_rel(got, want) <= ROW_TOL[dtype]


@pytest.mark.parametrize("cf", [None, "0.5"], ids=["cf-config", "cf-0.5"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_moe_ffn_matches_moe_ref_on_the_card(cuda, monkeypatch, arch, cf):
    """``moe_ffn`` against ``moe_ref`` on CUDA tensors, f32, at 16 experts
    (top-2 softmax for grok, top-4 sigmoid with a bias and a shared expert
    for deepseek) and d_model 256: outputs within 1e-4 of max|plain|, kept
    masks equal, and equal to the dispatch on the CPU."""
    if cf:
        monkeypatch.setenv("REPRO_MOE_CF", cf)
    cfg = reduced(get_config(arch), d_model=256)
    cfg_moe = dataclasses.replace(cfg.moe, n_experts=16, experts_per_token=(
        2 if arch == "grok-1-314b" else 4))
    gen = torch.Generator().manual_seed(6)
    p = {n: torch.randn(shape, generator=gen) * shape[0] ** -0.5
         for n, shape in moe.moe_params_shapes(cfg_moe, cfg.d_model,
                                               cfg.ffn).items()}
    p["router_bias"] = torch.randn(16, generator=gen) * 0.1
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    p_c, x_c = _to(p, cuda), x.to(cuda)
    got = moe.moe_ffn(x_c, p_c, cfg_moe, cfg.ffn, torch.float32)
    want, keep = moe.moe_ref(x_c, p_c, cfg_moe, cfg.ffn, torch.float32)
    assert _rel(got, want) <= 1e-4
    assert torch.equal(keep, moe.route(x_c.reshape(-1, cfg.d_model), p_c,
                                       cfg_moe).keep)
    assert torch.equal(keep.cpu(), moe.route(x.reshape(-1, cfg.d_model), p,
                                             cfg_moe).keep)
    if cf:
        assert not keep.all()


def test_moe_gqa_model_runs_flash_and_decode_kernels(cuda):
    """The reduced grok-1-314b, f32 compute: B2 once per layer a prefill,
    B4 once per layer a step, logits as on the CPU to 1e-4."""
    cfg = reduced(get_config("grok-1-314b"), compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(7))
    b2, b4, err = _model_on_both(cuda, cfg, {"tokens": toks}, 8, 48)
    assert b2 == cfg.n_layers and b4 == [cfg.n_layers] * 8
    assert err <= 1e-4


def test_mla_model_prefill_equals_decode_on_the_card(cuda, monkeypatch):
    """The reduced deepseek-v3-671b at d_model 256, f32 compute, no slot
    dropped: MLA launches neither B2 nor B4; the card's logits are the
    CPU's, and the prefill's last logits equal those after feeding the
    prompt through the absorbed decode over the latent cache (1e-4)."""
    monkeypatch.setenv("REPRO_MOE_CF", "8")
    cfg = reduced(get_config("deepseek-v3-671b"), compute_dtype="float32",
                  d_model=256)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(8))
    b2, b4, err = _model_on_both(cuda, cfg, {"tokens": toks}, 8, 48)
    assert b2 == 0 and b4 == [0] * 8
    assert err <= 1e-4
    params = _to(init_params(cfg, seed=0, device="cpu"), cuda)
    want = tfm.prefill(cfg, params, tokens=toks.to(cuda))
    cache = tfm.init_cache(cfg, 2, 40, dtype=torch.float32, device=cuda)
    for t in range(toks.shape[1]):
        got, cache = tfm.decode_step(cfg, params, toks[:, t].to(cuda), cache)
    assert _rel(got, want) <= 1e-4


# ----------------------------------------------------------------- training

def _kernel_calls(cuda):
    """(name, the wrapper called on small f32 operands on the card, with
    ``req`` requiring grad) for B1-B4."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, req=False):
        return torch.randn(shape, generator=gen,
                           device=cuda).requires_grad_(req)

    return [
        ("block_gemm", lambda req: block_gemm(randn(2, 8, 8, req=req),
                                              randn(2, 8, 8))),
        ("flash_attention", lambda req: flash_attention(
            randn(1, 2, 16, 32, req=req), randn(1, 2, 16, 32),
            randn(1, 2, 16, 32))),
        ("ssd_scan", lambda req: ssd_scan(
            randn(1, 16, 2, 8, req=req), torch.rand((1, 16, 2), device=cuda),
            -torch.rand((2,), device=cuda), randn(1, 16, 1, 8),
            randn(1, 16, 1, 8), q_chunk=8)),
        ("decode_attention", lambda req: decode_attention(
            randn(1, 2, 32, req=req), randn(1, 2, 16, 32),
            randn(1, 2, 16, 32))),
    ]


@pytest.mark.parametrize("which", range(4),
                         ids=["B1", "B2", "B3", "B4"])
def test_kernels_refuse_an_operand_that_requires_grad(cuda, which):
    """No kernel has a backward: under grad, with an operand that requires
    it, each wrapper raises instead of returning an output without a
    gradient; under no_grad (or with no operand requiring grad) it
    launches."""
    name, call = _kernel_calls(cuda)[which]
    with pytest.raises(RuntimeError, match=f"{name}: an operand requires"):
        call(True)
    with torch.no_grad():
        assert not call(True).requires_grad
    assert not call(False).requires_grad


def test_model_routes_attention_and_ssd_to_plain_under_grad(cuda):
    """Under grad the prefill attention and the SSD take their plain
    versions (no B2 or B3 launch) and carry gradients; under no_grad the
    same calls launch B2 and B3."""
    from repro_torch.models.attention import prefill_attention
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 2, 64, 32), generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    x = torch.randn((1, 64, 2, 8), generator=gen, device=cuda,
                    requires_grad=True)
    dt = torch.rand((1, 64, 2), device=cuda)
    a = -torch.rand((2,), device=cuda)
    bm, cm = (torch.randn((1, 64, 1, 8), generator=gen, device=cuda)
              for _ in range(2))
    flash_attention.launches = ssd_scan.launches = 0
    o = prefill_attention(q, k, v)
    y = ssd(x, dt, a, bm, cm, q_chunk=16)
    assert flash_attention.launches == ssd_scan.launches == 0
    (o.sum() + y.sum()).backward()
    assert q.grad is not None and x.grad is not None
    with torch.no_grad():
        o2 = prefill_attention(q, k, v)
        y2 = ssd(x, dt, a, bm, cm, q_chunk=16)
    assert flash_attention.launches == 1 and ssd_scan.launches == 1
    assert _rel(o2, o.detach()) <= TOL[torch.float32]
    assert _rel(y2, y.detach()) <= 2e-4


TRAIN_ARCHS = ["starcoder2-3b", "yi-6b", "llava-next-34b", "grok-1-314b",
               "deepseek-v3-671b", "mamba2-1.3b", "zamba2-1.2b",
               "seamless-m4t-large-v2"]


def train_batch(cfg, seed=3, seq=64, batch=2):
    """A seeded ``SyntheticLM`` batch for ``cfg``'s family as CPU tensors,
    every fifth label of the first row masked."""
    from repro_torch.train.data import SyntheticLM
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                     embed_dim=cfg.d_model if cfg.embed_inputs else None,
                     encdec=cfg.family == "encdec")
    b = ds.batch_at(0)
    b["labels"][0, ::5] = -1
    return {k: torch.from_numpy(v) for k, v in b.items()}


def train_cfg(arch):
    """The reduced config of the gradient gates: f32 compute and
    parameters; zamba2's window cut to 16, so S = 64 reaches it."""
    kw = {"sliding_window": 16} if arch == "zamba2-1.2b" else {}
    return reduced(get_config(arch), compute_dtype="float32",
                   param_dtype="float32", **kw)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_reduced_loss_and_grads_on_the_card_equal_the_cpu(cuda, monkeypatch,
                                                          arch):
    """``lm_loss`` and every gradient leaf of the reduced config, f32, on
    the card against the CPU from the same weights and batch, with the
    multi-chunk attention (``REPRO_ATTN_CHUNK=16``): loss to 1e-5
    relative, each leaf to 1e-4 of its max|g| (tests/test_torch_train.py's
    tolerances against the JAX package); no kernel launches."""
    from repro_torch.train.train_step import loss_and_grads
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "16")
    cfg = train_cfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    batch = train_batch(cfg)
    want_loss, want = loss_and_grads(cfg, params, batch)
    for kernel in (block_gemm, flash_attention, ssd_scan, decode_attention):
        kernel.launches = 0
    loss, got = loss_and_grads(cfg, _to(params, cuda), _to(batch, cuda))
    assert all(kernel.launches == 0 for kernel in (
        block_gemm, flash_attention, ssd_scan, decode_attention))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    stack = [(got, want)]
    while stack:
        g, w = stack.pop()
        if isinstance(w, dict):
            stack += [(g[k], w[k]) for k in w]
            continue
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(scale, 1e-30)


# ------------------------------------------------------------- pipeline

def test_pipelined_forward_launches_b2_per_stage_task(cuda):
    """The reduced starcoder2-3b (4 layers) through ``pipeline_apply`` on a
    logical 2-stage mesh, 4 microbatches, bf16 compute under no_grad: one
    B2 launch per layer per microbatch, and bit for bit the sequential
    ``_scan_segment`` applied microbatch by microbatch (the same ops on
    the same shapes)."""
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import Mesh

    cfg = reduced(get_config("starcoder2-3b"), n_layers=4)
    params = init_params(cfg, seed=0, device=cuda)
    layers = tfm.unstack(params["dense"])
    gen = torch.Generator(device=cuda).manual_seed(9)
    xs = torch.randn((4, 1, 128, cfg.d_model), generator=gen,
                     device=cuda).to(torch.bfloat16)

    def stage(stage_layers, x):
        return tfm._scan_segment(cfg, "dense", stage_layers, x)[0]

    with torch.no_grad():
        flash_attention.launches = 0
        pipeline_apply.stage_calls = 0
        ys = pipeline_apply(stage, [layers[:2], layers[2:]], xs,
                            mesh=Mesh((2,), ("pipe",), cuda))
        torch.cuda.synchronize()
        assert pipeline_apply.stage_calls == 8
        assert flash_attention.launches == 4 * 4
        want = torch.stack([stage(layers, xs[m]) for m in range(4)])
    assert torch.equal(ys, want)


def test_pipelined_loss_and_grads_on_the_card_equal_the_cpu(cuda):
    """The pipelined train step's loss and gradients (reduced starcoder2-3b,
    4 layers, 2 stages, 4 microbatches, f32) on the card against the CPU,
    to 1e-4 of each leaf's max|g|, with no kernel launched (under grad the
    attention takes its plain version)."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.train_step import (make_pipeline_loss,
                                              value_and_grads)
    from repro_torch.train.tree import leaf_paths, tree_map

    cfg = reduced(get_config("starcoder2-3b"), n_layers=4,
                  compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, 64, 8, learnable=True)
             .batch_at(0).items()}
    want_loss, want = value_and_grads(
        make_pipeline_loss(cfg, make_pipeline_mesh(2, 2, "cpu"), n_micro=4),
        params, batch)
    flash_attention.launches = 0
    loss, got = value_and_grads(
        make_pipeline_loss(cfg, make_pipeline_mesh(2, 2, cuda), n_micro=4),
        tree_map(lambda t: t.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()})
    assert flash_attention.launches == 0
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for (name, g), (_, w) in zip(leaf_paths(got), leaf_paths(want)):
        err = float((g.cpu() - w).abs().max() / w.abs().max().clamp(
            min=1e-30))
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("transport", ["device", "gloo"])
def test_ranked_gemm_runs_b1_on_every_rank(cuda, transport):
    """Two rank processes share the card (the device transport's mailboxes,
    or gloo over pinned host buffers): a GEMM on a 1 x 2 grid with B1,
    each rank's launches equal to its gemm calls, its C blocks bit for bit
    the one-device executor's; only gloo stages bytes through the host."""
    from repro_torch.dist.ranks import spawn_ranks
    from repro_torch.linalg.gemm import (gemm_2d_program, gemm_executor,
                                         gemm_rank, make_blocks)

    nb, b = 4, 64
    per_rank = spawn_ranks(gemm_rank, 2, nb, b, [{"auto": True}],
                           device="cuda", timeout=300, transport=transport,
                           pr=1, pc=2, kernel=True, on_device=True,
                           keep=("C",))
    prog = gemm_2d_program(nb, 1, 2, b)
    blocks = make_blocks(None, nb, b, device=cuda)
    one = gemm_executor(prog, matmul=task_matmul, device=cuda)(
        prog.pack(blocks, device=cuda))
    for (run,) in per_rank:
        assert run["launches"]["block_gemm"] == run["calls"]["gemm"] > 0
        assert run["transport"] == transport
        assert (run["staged_bytes"] > 0) == (transport == "gloo")
        assert len(run["slots"]) == nb * nb // 2
        for slot, blk in zip(run["slots"], run["row"]):
            assert torch.equal(blk, one[run["rank"], slot].cpu())


def pipelined_step_rank(rank, world, *, device):
    """Two steps of the reduced starcoder2-3b (4 layers, f32) on this
    rank's stage of a (2, 1, 1) mesh of ranks: the losses, |g|, kernel
    launches and the bytes the rank sent."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import (make_pipeline_train_step,
                                              pipeline_shard)

    cfg, batch = _pipelined_cell(device)
    mesh = make_pipeline_mesh(2, world, device, group=dist.group.WORLD)
    params = pipeline_shard(cfg, init_params(cfg, seed=0, device=device),
                            mesh)
    opt = adamw_init(params)
    step = make_pipeline_train_step(cfg, mesh, lr=1e-3, n_micro=4)
    launches = sum(k.launches for k in (block_gemm, flash_attention,
                                        ssd_scan, decode_attention))
    metrics = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "bytes": mesh.transport.bytes["p2p"],
            "staged": mesh.transport.staged_bytes,
            "launches": sum(k.launches for k in (
                block_gemm, flash_attention, ssd_scan, decode_attention))
            - launches}


def _pipelined_cell(device):
    from repro_torch.train.data import SyntheticLM

    cfg = reduced(get_config("starcoder2-3b"), n_layers=4,
                  compute_dtype="float32")
    batch = SyntheticLM(cfg.vocab_size, 64, 8, learnable=True).batch_at(0)
    batch["labels"][0, ::5] = -1
    return cfg, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("transport", ["device", "gloo"])
def test_pipelined_step_on_two_stage_ranks(cuda, transport):
    """The reduced starcoder2-3b's pipelined train step on two stage ranks
    that share the card (the device transport's mailboxes, or gloo over
    pinned host buffers): two steps' loss and |g| within 1e-6 and 1e-5
    relative of the logical step's on the card, no kernel launched, each
    stage's 4 hand-offs a step (8 x 64 tokens of d_model f32) sent to the
    other, and staged through the host on gloo only."""
    from repro_torch.dist.ranks import spawn_ranks
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_pipeline_train_step

    per_rank = spawn_ranks(pipelined_step_rank, 2, device="cuda",
                           timeout=600, transport=transport)
    cfg, batch = _pipelined_cell(cuda)
    params = init_params(cfg, seed=0, device=cuda)
    opt = adamw_init(params)
    step = make_pipeline_train_step(cfg, make_pipeline_mesh(2, 2, cuda),
                                    lr=1e-3, n_micro=4)
    want = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    handoffs = 2 * 8 * 64 * cfg.d_model * 4
    for r, run in enumerate(per_rank):
        for (loss, norm), (w_loss, w_norm) in zip(run["metrics"], want):
            assert abs(loss - w_loss) <= 1e-6 * w_loss, (r, loss, w_loss)
            assert abs(norm - w_norm) <= 1e-5 * w_norm, (r, norm, w_norm)
        assert run["launches"] == 0
        assert run["bytes"] == ([0, handoffs] if r == 0 else [handoffs, 0])
        if transport == "gloo":
            assert run["staged"] >= 2 * handoffs
        else:
            assert run["staged"] == 0


def _tp_cfg():
    """The reduced yi-6b at heads of 64 (4 query heads over 2 KV heads),
    bf16 compute."""
    return reduced(get_config("yi-6b"), d_head=64)


def tensor_parallel_rank(rank, world, *, device):
    """The reduced yi-6b on this rank of a (1, 2) mesh of ranks: its shard
    of the seed-0 weights, prefill of 1 x 64 seeded tokens, then 3 serve
    steps fed seeded tokens over its shard of a 128-position cache; the B2
    and B4 launches of each and the logits."""
    import torch.distributed as dist

    from repro_torch.dist.ctx import launch_mesh
    from repro_torch.dist.tensor_parallel import (init_shard_cache,
                                                  init_shard_params)
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = _tp_cfg()
    mesh = make_dev_mesh(world, device=device, group=dist.group.WORLD)
    params = init_shard_params(cfg, mesh, seed=0, device=device)
    toks, fed = _tp_inputs(cfg, device)
    with torch.inference_mode(), launch_mesh(mesh, global_batch=2):
        flash_attention.launches = decode_attention.launches = 0
        prefill = make_prefill_step(cfg)(params, {"tokens": toks})
        torch.cuda.synchronize()
        counts = [(flash_attention.launches, decode_attention.launches)]
        cache = init_shard_cache(cfg, mesh, 2, 128, device=device)
        step = make_serve_step(cfg)
        logits = []
        for tok in fed:
            flash_attention.launches = decode_attention.launches = 0
            _, lg, cache = step(params, tok, cache)
            torch.cuda.synchronize()
            counts.append((flash_attention.launches,
                           decode_attention.launches))
            logits.append(lg)
    return {"counts": counts, "prefill": prefill.float().cpu(),
            "steps": torch.stack(logits).float().cpu(),
            "heads": tuple(cache.layers["dense"][0].shape)}


def _tp_inputs(cfg, device):
    gen = torch.Generator(device=device).manual_seed(3)
    return (torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                          device=device),
            torch.randint(0, cfg.vocab_size, (3, 2), generator=gen,
                          device=device))


def test_tensor_parallel_ranks_launch_b2_and_b4_on_their_head_shard(cuda):
    """Two rank processes that share the card, each with 2 of the 4 query
    heads and 1 of the 2 KV heads: every prefill makes one B2 launch a
    layer on each rank and every serve step one B4 launch a layer, none
    else; the gathered logits within the bf16 gate (2e-2 of max|logit|) of
    the one-process run on the same seed, every rank's the same."""
    from repro_torch.dist.ranks import spawn_ranks
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    runs = spawn_ranks(tensor_parallel_rank, 2, device="cuda", timeout=600)
    cfg = _tp_cfg()
    params = init_params(cfg, seed=0, device=cuda)
    toks, fed = _tp_inputs(cfg, cuda)
    with torch.inference_mode():
        want = [make_prefill_step(cfg)(params, {"tokens": toks})]
        cache = tfm.init_cache(cfg, 2, 128, device=cuda)
        for tok in fed:
            _, lg, cache = make_serve_step(cfg)(params, tok, cache)
            want.append(lg)
    want = [w.float().cpu() for w in want]
    n = cfg.n_layers
    for run in runs:
        assert run["counts"] == [(n, 0)] + [(0, n)] * 3
        assert run["heads"] == (n, 2, 1, 128, cfg.head_dim)
        assert torch.equal(run["prefill"], runs[0]["prefill"])
        assert torch.equal(run["steps"], runs[0]["steps"])
    for got, w in zip([runs[0]["prefill"], *runs[0]["steps"]], want):
        assert float((got - w).abs().max() / w.abs().max()) <= 2e-2


def mailbox_rank(rank, world, *, device):
    """On a world of 4 that share the card: this rank's and its peers'
    mailboxes (device pointers, mapped by CUDA IPC), then an f32
    all-reduce of 40 MiB (in 32 MiB pieces) and a bf16 all-gather through
    them; what arrived, on the CPU."""
    import torch.distributed as dist

    from repro_torch.dist import ranks

    box = ranks._MAILBOX
    net = ranks.tensor_transport(device)
    gen = torch.Generator(device=device).manual_seed(rank)
    x = torch.randn(10 << 20, device=device, generator=gen)
    y = torch.randn(3, 5, device=device, generator=gen).bfloat16()
    total = net.all_reduce(x.clone(), dist.group.WORLD)
    parts = net.all_gather(y, dist.group.WORLD)
    torch.cuda.synchronize()
    return {"transport": type(net).__name__,
            "pointers": [t.data_ptr() for t in box.boxes],
            "device": [t.device.type for t in box.boxes],
            "x": x.cpu(), "y": y.cpu(), "total": total.cpu(),
            "parts": [p.cpu() for p in parts],
            "staged": net.staged_bytes, "bytes": net.bytes["reduce"]}


def test_mailboxes_map_peers_on_the_card(cuda):
    """Four rank processes on one card map each other's device mailboxes
    (allocated outside PyTorch's caching allocator, opened by CUDA IPC
    handle): an f32 all-reduce equals the rank-order tree sum on every
    rank, bit for bit, and a bf16 all-gather each rank's tensor; nothing
    staged."""
    from repro_torch.dist.ranks import MAILBOX_BYTES, spawn_ranks

    runs = spawn_ranks(mailbox_rank, 4, device="cuda", timeout=300)
    want = ((runs[0]["x"].to(cuda) + runs[1]["x"].to(cuda))
            + (runs[2]["x"].to(cuda) + runs[3]["x"].to(cuda)))
    for r, run in enumerate(runs):
        assert run["transport"] == "DeviceTensorTransport"
        assert run["device"] == ["cuda"] * 4
        assert len(set(run["pointers"])) == 4
        assert torch.equal(run["total"], want.cpu()), r
        for p, other in zip(run["parts"], runs):
            assert torch.equal(p, other["y"])
        assert run["staged"] == 0
        assert run["bytes"] == [0 if p == r else (10 << 20) * 4
                                for p in range(4)]
    assert MAILBOX_BYTES == 256 << 20
