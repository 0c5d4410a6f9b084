"""The port's input pipeline, step accounting, dtype policy and checkpoints.

The pipeline's index order and straggler fillers (``sample_weight`` 0) must equal the
JAX package's for the same seed: both run the same shard/shuffle arithmetic and the
same ``fixed_batcher``; the port moves batches with torch instead of
``jax.device_put``. Exact equality throughout (integers and copies).
"""

import os

import numpy as np
import pytest
import torch

from projectiontrainer_tpu.data import pipeline as JP
from projectiontrainer_tpu.train import common as JC
from projectiontrainer_tpu_torch.checkpoint.manager import CheckpointManager
from projectiontrainer_tpu_torch.core import dtypes
from projectiontrainer_tpu_torch.data import pipeline as P
from projectiontrainer_tpu_torch.train import common, masks, optim, steps

torch.set_num_threads(2)


class IndexDataset:
    """Sample i carries i in its pixels and caption, so batches reveal the order."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"pixel_values": np.full((2, 2, 3), i, np.float32),
                "caption_ids": np.array([i, i + 1, 0], np.int32)}


@pytest.mark.parametrize("n,pc", [(11, 1), (11, 3), (16, 4)])
def test_host_shard_indices_match_jax(n, pc):
    for epoch in (0, 3):
        for pi in range(pc):
            for shuffle in (True, False):
                kw = dict(epoch=epoch, seed=7, shuffle=shuffle, process_index=pi,
                          process_count=pc)
                np.testing.assert_array_equal(P.host_shard_indices(n, **kw),
                                              JP.host_shard_indices(n, **kw))


@pytest.mark.parametrize("workers", [0, 3])
def test_epoch_batches_match_jax_order_and_fillers(workers):
    ds = IndexDataset(11)  # 11 samples at batch 4: the last batch has one filler row
    kw = dict(batch_size=4, epoch=2, seed=5, shuffle=True, num_workers=workers)
    ours = list(P.epoch_batches(ds, device="cpu", **kw))
    theirs = list(JP.epoch_batches(ds, **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"pixel_values", "caption_ids", "sample_weight"}
        for key in a:
            assert isinstance(a[key], torch.Tensor)
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    np.testing.assert_array_equal(ours[-1]["sample_weight"].numpy(), [1, 1, 1, 0])


def test_device_prefetch_raises_the_feeders_error():
    def batches():
        yield {"x": np.zeros(2)}
        raise RuntimeError("decode failed")

    it = P.device_prefetch(batches(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_step_accounting_matches_jax():
    for n, gbs, accum, epochs in ((11, 4, 1, 3), (32, 4, 2, 1), (7, 2, 3, 2)):
        assert common.steps_per_epoch(n, gbs) == JC.steps_per_epoch(n, gbs, process_count=1)
        assert common.update_steps(n, gbs, accum, epochs) == JC.update_steps(
            n, gbs, accum, epochs, process_count=1)


def test_cast_compute_params_keeps_fp32_masters_and_their_grads():
    master = torch.randn(3, 4, requires_grad=True)
    tree = {"a": {"weight": master}, "q": {"scales": torch.ones(2)},
            "ids": torch.arange(3)}
    cast = dtypes.cast_compute_params(tree, torch.bfloat16)
    assert cast["a"]["weight"].dtype == torch.bfloat16
    assert cast["q"]["scales"].dtype == torch.float32 and cast["ids"].dtype == torch.int64
    cast["a"]["weight"].float().sum().backward()
    assert master.grad is not None and master.grad.dtype == torch.float32
    bf = torch.zeros(2, dtype=torch.bfloat16)
    assert dtypes.cast_compute_params({"x": bf}, torch.bfloat16)["x"] is bf  # no copy
    assert dtypes.compute_dtype("bf16") is torch.bfloat16 and dtypes.compute_dtype("no") is None


def test_checkpoint_manager_round_trip(tmp_path):
    params = {"projector": {"fc1": {"weight": torch.randn(3, 2)}},
              "llm": {"w": torch.randn(2)}}
    labels = masks.stage1_labels(params)
    tx, _ = optim.single_group_optimizer(labels, 1e-2, total_steps=4, accum_steps=2)
    state = steps.init_state(params, tx)
    tx.update({"projector/fc1/weight": torch.ones(3, 2)}, state["opt_state"], params)
    tx.update({"projector/fc1/weight": torch.ones(3, 2)}, state["opt_state"], params)
    state["step"] = 2
    mgr = CheckpointManager(str(tmp_path), save_every_n_epochs=1)
    mgr.save_step(1, state)
    mgr.save_step(2, state)
    assert mgr.latest_step() == 2 and not mgr.has("step_1")  # only the newest step_K
    assert mgr.save_best(1.0, state) and not mgr.save_best(2.0, state)
    saved = {k: v.clone() for k, v in state["opt_state"]["mu"].items()}
    weight = params["projector"]["fc1"]["weight"].clone()

    fresh = {"projector": {"fc1": {"weight": torch.zeros(3, 2)}}, "llm": {"w": torch.randn(2)}}
    restored = mgr.restore("step_2", steps.init_state(fresh, tx))
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 1
    torch.testing.assert_close(fresh["projector"]["fc1"]["weight"], weight)
    torch.testing.assert_close(restored["opt_state"]["mu"]["projector/fc1/weight"],
                               saved["projector/fc1/weight"])
    assert CheckpointManager(str(tmp_path)).save_best(1.5, state) is False  # best persists


def test_step_timer_charges_a_window_from_before_its_first_step():
    import time

    from projectiontrainer_tpu_torch.utils.timing import StepTimer

    timer = StepTimer(warmup_steps=0)
    for _ in range(2):
        timer.begin()
        time.sleep(0.02)  # a step whose work blocks the host (eager PyTorch)
        timer.count(images=4)
    timer.window_end()
    out = timer.summary()
    assert out["step_time_ms"] >= 20 and out["images_per_sec"] <= 4 / 0.02


def test_step_profiler_writes_a_trace_of_its_window(tmp_path):
    from projectiontrainer_tpu_torch.utils.timing import StepProfiler

    prof = StepProfiler(str(tmp_path), start_step=1, num_steps=2)
    for step in range(5):
        prof.step(step)
        torch.ones(8).sum()
    prof.close()
    assert os.listdir(tmp_path) == ["trace_step1.json"]
    assert StepProfiler(str(tmp_path / "x"), rank=1).log_dir is None  # rank 0 only


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::flash_fwd_kernel<72>(CUtensorMap_st, ...)", "attention"),
    ("void (anonymous namespace)::dkv::flash_bwd_dkv_wgmma_kernel<256>(...)", "attention"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<64>(...)", "attention"),
    ("void (anonymous namespace)::decode_attn_kernel<256>(...)", "attention"),
    ("void (anonymous namespace)::fused_ce_bwd_kernel(...)", "fused_ce"),
    ("_layernorm_bwd_kernel", "layernorm"),
    ("void (anonymous namespace)::layernorm_bwd_kernel<__nv_bfloat16>(...)", "layernorm"),
    ("void (anonymous namespace)::layernorm_bwd_kernel<float>(...)", "layernorm"),
    ("layernorm_fwd", "layernorm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>", "reduce"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "copy"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl...>",
     "elementwise"),
])
def test_kernel_family_of_a_trace_name(name, family):
    from projectiontrainer_tpu_torch.utils.timing import kernel_family

    assert kernel_family(name) == family


class QADataset:
    """Stage-2 samples whose question and answer lengths vary with i and carry i."""

    def __init__(self, n):
        self.q_lens = np.array([3 + i % 5 for i in range(n)])
        self.a_lens = np.array([2 + (7 * i) % 11 for i in range(n)])

    def __len__(self):
        return len(self.q_lens)

    def token_lengths(self):
        return self.q_lens, self.a_lens

    def __getitem__(self, i):
        return {"pixel_values": np.full((2, 2, 3), i, np.float32),
                "question_ids": np.full(self.q_lens[i], i + 1, np.int32),
                "answer_ids": np.full(self.a_lens[i], i + 2, np.int32)}


@pytest.mark.parametrize("n,batch,workers", [(11, 3, 1), (16, 4, 2), (5, 8, 2)])
def test_planned_epoch_batches_match_jax(n, batch, workers):
    """Stage 2's bucket plan run by both pipelines: the same batches, padded to the same
    buckets, with the same filler weights (exact)."""
    from projectiontrainer_tpu_torch.data import bucketing

    data = QADataset(n)
    plan = bucketing.global_bucket_plan(*data.token_lengths(), batch_size=batch, epoch=1,
                                        seed=3, q_buckets=(4, 8), a_buckets=(4, 8, 16))
    ours = list(P.planned_epoch_batches(data, plan, pad_id=0, device="cpu",
                                        num_workers=workers))
    theirs = list(JP.planned_epoch_batches(data, plan, pad_id=0, num_workers=workers,
                                           transform=lambda b: b))
    assert len(ours) == len(theirs) == len(plan)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"pixel_values", "question_ids", "answer_ids", "sample_weight"}
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_left_align_padding_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, size=(6, 9)).astype(np.int32)
    left = common.left_align_padding(ids, 0)
    np.testing.assert_array_equal(left, JC.left_align_padding(ids, 0))
    assert (left[(ids != 0).any(1), -1] != 0).all()  # a row with a token ends on one
