"""The port's data mesh and process-group helpers (``core/mesh.py``,
``parallel/distributed.py``) against the JAX package's, on the CPU.

- ``MeshConfig.resolve`` over a grid of (data, model, devices): the JAX package's
  results, and its errors (type and message).
- ``build_mesh`` over the world: -1 is every rank, a mesh smaller than the world
  raises (the JAX package would take a prefix of its devices: an idle rank has nothing
  to do), and a model axis resolves with it (rank r at (r // model, r % model)).
- Four gloo processes (``tests/torch_dp_worker.py collectives``; each bounded by 120 s,
  its collectives by 60 s): ``gather_ragged`` and ``gather_objects`` at per-rank counts
  3/5/7/9, the case of the JAX package's ``tests/test_multihost.py:32``, an empty rank,
  a bool array; ``all_gather_with_grad``'s gradient against the gradient of one
  process's concatenation; the coalesced gradient all-reduce across a bucket boundary
  and mixed types; ``broadcast_``; ``broadcast_value``; the dropout seeds (rank 0
  keeps a single process's, every other rank draws its own); ``barrier``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from projectiontrainer_tpu.core import mesh as jax_mesh
from projectiontrainer_tpu_torch.core import mesh
from projectiontrainer_tpu_torch.parallel import distributed

import torch_dp_worker

WORLD = 4


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the outcome compared is the error itself
        return type(e).__name__, str(e)


@pytest.mark.parametrize("data,model", [(d, m) for d in (-1, 1, 2, 3, 4, 8)
                                        for m in (-1, 1, 2, 4)])
def test_mesh_config_resolve_matches_jax(data, model):
    for n in (1, 2, 4, 8):
        ours = _outcome(lambda: mesh.MeshConfig(data, model).resolve(n))
        theirs = _outcome(lambda: jax_mesh.MeshConfig(data, model).resolve(n))
        assert ours == theirs, (data, model, n)


# a fully specified mesh smaller than the world takes its first ranks (2 of 4), as the JAX
# package takes a prefix of its devices; a larger one raises
@pytest.mark.parametrize("data,world,expect", [
    (-1, 1, 1), (-1, 4, 4), (4, 4, 4), (1, 1, 1),
    (2, 4, 2), (8, 4, ValueError), (2, 1, ValueError)])
def test_build_mesh_resolves_over_the_world(data, world, expect):
    if isinstance(expect, int):
        got = mesh.build_mesh(mesh.MeshConfig(data, 1), world)
        assert (got.data, got.model, got.size) == (expect, 1, expect)
    else:
        with pytest.raises(expect, match="projectiontrainer-torch-launch"):
            mesh.build_mesh(mesh.MeshConfig(data, 1), world)


# the model axis is ported (tensor parallelism, tests/test_torch_tp.py): over a world of
# 4 it resolves to 2 x 2; 1 x 2 is a mesh of the world's first 2 ranks, and a mesh larger
# than the world is refused as the data axis's is
@pytest.mark.parametrize("data,model", [(1, 2), (4, 2), (-1, 2), (2, -1)])
def test_build_mesh_refuses_the_model_axis(data, model):
    if data * model > 4:
        with pytest.raises(ValueError, match="projectiontrainer-torch-launch"):
            mesh.build_mesh(mesh.MeshConfig(data, model), 4)
        return
    if -1 not in (data, model):
        got = mesh.build_mesh(mesh.MeshConfig(data, model), 4)
        assert (got.data, got.model, got.size) == (data, model, data * model)
        return
    got = mesh.build_mesh(mesh.MeshConfig(data, model), 4)
    assert (got.data, got.model, got.size) == (2, 2, 4)


def test_single_process_helpers_are_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert distributed.world_size() == 1 and distributed.rank() == 0 and distributed.is_main()
    assert distributed.all_gather_with_grad(x) is x and distributed.sum_over_ranks(x) is x
    assert distributed.gather_objects(["a"]) == ["a"]
    np.testing.assert_array_equal(distributed.gather_ragged(x.numpy()), x.numpy())
    assert distributed.rank_seed(7) == 7 and distributed.broadcast_value(1.5) == 1.5
    assert distributed.initialize("cpu") == (0, 1)
    distributed.barrier()


@pytest.mark.parametrize("ranks", [3, 5])
def test_nccl_refuses_ranks_beyond_the_gpus(ranks, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--backend gloo"):
        distributed.check_backend("nccl", "cuda", ranks)
    distributed.check_backend("gloo", "cuda", ranks)
    distributed.check_backend("nccl", "cuda", 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        distributed.check_backend("nccl", "cpu", 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("collectives"))
    torch_dp_worker.spawn_ranks("collectives", d, WORLD)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


@functools.cache
def _expected_rows():
    return np.concatenate([np.arange((3 + 2 * r) * 3, dtype=np.float32).reshape(-1, 3) + 100 * r
                           for r in range(WORLD)])


def test_gather_ragged_at_counts_3_5_7_9(ranks):
    for out in ranks:
        assert out["ragged"].shape == (24, 3) and out["ragged"].dtype == np.float32
        np.testing.assert_array_equal(out["ragged"], _expected_rows())
        bools = np.concatenate([np.arange(3 + 2 * r) % 2 == 0 for r in range(WORLD)])
        np.testing.assert_array_equal(out["ragged_bool"], bools)
        assert out["ragged_bool"].dtype == np.bool_
        assert out["empty"].shape == (2 * (WORLD - 1), 4) and out["empty"].dtype == np.int64


def test_gather_objects_in_rank_order(ranks):
    expected = [f"r{r}-{i}" for r in range(WORLD) for i in range(3 + 2 * r)]
    assert all(out["objects"] == expected for out in ranks)


def test_all_gather_with_grad_matches_one_process_concatenation(ranks):
    xs = [out["x"].clone().requires_grad_(True) for out in ranks]
    cat = torch.cat(xs)
    total = sum((cat * torch.tensor(np.random.default_rng(10 + r).standard_normal(
        (2 * WORLD, 4)), dtype=torch.float32)).sum() for r in range(WORLD))
    total.backward()
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["gathered"], cat.detach())
        torch.testing.assert_close(out["x_grad"], xs[r].grad, rtol=1e-6, atol=1e-6)


def test_coalesced_all_reduce_and_broadcast(ranks):
    s = sum(r + 1 for r in range(WORLD))
    for out in ranks:
        a, b, c, d = out["reduced"]
        assert torch.equal(a, torch.full((5,), float(s)))
        assert torch.equal(b, torch.full((3, 2), 2.0 * s))
        assert c.dtype == torch.bfloat16 and torch.equal(c, torch.full((4,), float(s),
                                                                       dtype=torch.bfloat16))
        assert torch.equal(d, torch.full((2,), 3.0 * sum(range(WORLD))))
        assert torch.equal(out["broadcast"][0], torch.zeros(3))
        assert torch.equal(out["broadcast"][1], torch.zeros(2, 2))
        assert out["value"] == 0.5 and float(out["summed"]) == s


def test_each_rank_draws_its_own_dropout_seeds(ranks):
    from projectiontrainer_tpu_torch.train import lora

    assert ranks[0]["rank_seed"] == 5
    assert ranks[0]["lora_seed"] == lora.dropout_seed(5, 1, "q_proj")  # one process's
    assert len({out["rank_seed"] for out in ranks}) == WORLD
    assert len({out["lora_seed"] for out in ranks}) == WORLD


def test_barrier_holds_every_rank_until_the_last_arrives(ranks):
    last = max(out["arrived"] for out in ranks)
    assert all(out["left"] >= last for out in ranks)
