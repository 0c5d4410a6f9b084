"""The LayerNorm backward kernel (K8) at any width: its plan and the port's LayerNorm at
widths the kernel used to refuse (D not a multiple of 8, D above 4096).

``bwd_plan`` at D = 1000, 1001, 1004, 4104, 6144 and 8192, bf16 and fp32 rows: no raise,
every row in one band, shared memory within the 227 KB a block may use; the widths the
kernel took before keep their plan; a D whose one ring row of x and dy and fp32 scale
would not fit (20480, 24577, 32768) takes the streamed kernel's plan, one row at a time
in chunks of 512 vectors, a CTA an SM. ``bwd_direct`` sends the rows a bulk copy cannot
take to the row warps' cp.async. K2's plan: the whole row in registers up to 16384,
column chunks above. Then the port's LayerNorm forward and backward
(the plain versions the kernels hold to, inside the same ``torch.autograd.Function``)
against ``jax.grad`` of the JAX package's ``layernorm`` at 1004 (its XLA path, which it
takes there) and 6144 (also its Pallas kernel in interpret mode), fp32, numpy inputs
from a seed; tolerance: max |error| within 1e-5 of max |reference|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projectiontrainer_tpu.ops import fused_layernorm as JFLN
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

torch.set_num_threads(2)
REL = 1e-5


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [1000, 1001, 1004, 4104, 6144, 8192])
@pytest.mark.parametrize("n", [16, 4096, 16384])
def test_bwd_plan_takes_the_new_widths(n, d, itemsize):
    plan = FLN.bwd_plan(n, d, 132, itemsize)
    assert plan["smem_bytes"] == FLN.bwd_smem_bytes(d, itemsize, plan["rows"], plan["stages"])
    assert plan["smem_bytes"] <= FLN.SMEM_LIMIT and plan["stages"] >= 3
    covered = np.zeros(n, int)
    for start, count in FLN.bwd_bands(n, plan["ctas"]):
        covered[start:start + count] += 1
    assert (covered == 1).all()
    slot = FLN.bwd_slot(d)
    assert slot % 8 == 0 and d <= slot < d + 8
    bufs = FLN.bwd_buffers(n, d, torch.bfloat16, plan)
    assert bufs["dx"][0] == (n, d) and bufs["part"][0] == (plan["ctas"], 2, slot)


@pytest.mark.parametrize("d", [64, 1024, 1152, 4096])
def test_the_old_widths_keep_their_plan(d):
    """A multiple of 8 up to 4096: the slot is D, so the shared memory and plan are
    the ones the kernel had."""
    assert FLN.bwd_slot(d) == d
    for itemsize in (2, 4):
        for rows in (8, 4, 2, 1):
            for stages in (1, 3, 4):
                ring = stages * rows * 2 * d * itemsize
                assert FLN.bwd_smem_bytes(d, itemsize, rows, stages) == (
                    max(ring, 4 * max(2 * d, FLN.BWD_THREADS)) + 4 * d + 8 * stages * rows
                    + 24 * stages)
    assert FLN.bwd_plan(16384, 1152, 132) == {"ctas": 132, "rows": 8, "stages": 4,
                                              "smem_bytes": 152416}


def test_the_widest_rows():
    """The widest ring row (19,368 in bf16) keeps the ring; one wider, where the plan
    used to raise, streams its rows."""
    widest = max(d for d in range(19000, 20000) if FLN.bwd_smem_bytes(d, 2, 1, 1) <= FLN.SMEM_LIMIT)
    assert widest == 19368
    assert FLN.bwd_plan(8, widest, 132)["rows"] == 1
    assert FLN.bwd_plan(8, widest + 1, 132) == {"ctas": 8, "rows": 1, "stages": 0,
                                                "streamed": True, "chunk": 4096,
                                                "smem_bytes": 0}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,d", [(2048, 20480), (1000, 24577), (512, 32768), (2, 32768),
                                 (131, 20480)])
def test_streamed_plan(n, d, itemsize):
    """Rows too wide for one ring row: the streamed kernel, a CTA an SM (one up to two
    rows), every row in one band, 16 bytes a thread of 512 a chunk; its partial sums as
    the ring's."""
    plan = FLN.bwd_plan(n, d, 132, itemsize)
    assert plan["streamed"] and plan["stages"] == 0 and plan["rows"] == 1
    assert plan["ctas"] == (1 if n <= 2 else min(132, n))
    assert plan["chunk"] == FLN.BWD_STREAM_THREADS * 16 // itemsize
    covered = np.zeros(n, int)
    for start, count in FLN.bwd_bands(n, plan["ctas"]):
        covered[start:start + count] += 1
    assert (covered == 1).all() and not FLN.bwd_ragged(n, plan)
    bufs = FLN.bwd_buffers(n, d, torch.bfloat16, plan)
    assert bufs["part"][0] == (plan["ctas"], 2, FLN.bwd_slot(d))


def test_forward_plan():
    assert FLN.fwd_plan(1152) == {"block": 2048, "chunked": False, "num_warps": 4}
    assert FLN.fwd_plan(16384) == {"block": 16384, "chunked": False, "num_warps": 8}
    for d in (16385, 20480, 24577, 32768):
        assert FLN.fwd_plan(d) == {"block": FLN.FWD_CHUNK, "chunked": True, "num_warps": 8}


def test_direct_rows():
    """Rows that are not 16-byte multiples, or do not start on 16 bytes, go to the
    row warps' cp.async; the rest to bulk copies."""
    rows = torch.zeros((8, 1160), dtype=torch.bfloat16)
    assert not FLN.bwd_direct(rows[:, :1152], rows[:, :1152])
    assert not FLN.bwd_direct(rows[:, 8:1160], rows[:, :1152])  # 16 bytes in
    assert FLN.bwd_direct(rows[:, 4:1156], rows[:, :1152])      # 8 bytes in
    assert FLN.bwd_direct(rows[:, :1004], rows[:, :1004].contiguous())  # 2008-byte rows
    odd = rows.view(-1)[:8 * 1156].view(8, 1156)
    assert FLN.bwd_direct(odd[:, :1152], rows[:, :1152])        # a 2312-byte stride
    f32 = torch.zeros((8, 1004), dtype=torch.float32)
    assert not FLN.bwd_direct(f32, f32)                        # 4016 = 251 x 16


def _case(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(d) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    return x, scale, bias, dy


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    err = np.abs(ours.detach().numpy() - theirs).max()
    assert err <= REL * np.abs(theirs).max(), err


@pytest.mark.parametrize("d", [1004, 6144, 20480, 24577])
def test_layernorm_matches_jax(d, monkeypatch):
    x, scale, bias, dy = _case(24, d, d)
    tx, ts, tb = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    before = (FLN.launches.value, FLN.bwd_launches.value)
    out = FLN.layernorm({"scale": ts, "bias": tb}, tx, eps=1e-6)
    (out * torch.tensor(dy)).sum().backward()
    assert (FLN.launches.value, FLN.bwd_launches.value) == before  # CPU: plain versions

    def loss(x_, s_, b_):
        return jnp.sum(JFLN.layernorm({"scale": s_, "bias": b_}, x_, eps=1e-6) * dy)

    args = tuple(map(jnp.asarray, (x, scale, bias)))
    _close(out, JFLN.layernorm({"scale": args[1], "bias": args[2]}, args[0], eps=1e-6))
    for ours, theirs in zip((tx.grad, ts.grad, tb.grad), jax.grad(loss, argnums=(0, 1, 2))(*args)):
        _close(ours, theirs)
    dx, dscale, dbias = FLN.layernorm_bwd_reference(tx.detach(), torch.tensor(dy), ts.detach())
    _close(dx, tx.grad.numpy())
    if d % 128 == 0:  # the JAX Pallas kernel takes this width: interpret mode
        monkeypatch.setattr(JFLN, "_BLOCK_ROWS", 8)
        jdx, jds, jdb = JFLN._bwd(args[0], jnp.asarray(dy), args[1], eps=1e-6, interpret=True)
        for ours, theirs in ((dx, jdx), (dscale, jds), (dbias, jdb)):
            _close(ours, theirs)
