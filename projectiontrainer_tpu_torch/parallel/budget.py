"""Memory and collective budget of the full-joint ``--fsdp`` stage-2 step on H100s,
without the cards.

Counterpart of ``projectiontrainer_tpu/parallel/budget.py:full_joint_budget``, which
compiles the JAX step for a v5e topology ahead of time and reads the compiler's memory
analysis. The port has no compiler to ask, so it runs its own program on tensors that
hold no data: rank 0 of a world of ``n_devices`` ranks on the ``fake`` backend
(``distributed.fake_world``: every collective returns at once and moves nothing), the
model's leaves made from the config alone (``vlm.init`` on the meta device), sliced on
the model axis as ``setup.build_vlm`` slices them, then placed, cast and given their
optimizer and step by the trainer's own code (``trainer_stage2.build_stage2``: the
data shards of ``common.place_params``, ``MaskedAdamW`` of the epoch-0 variant with
per-module clipping and accumulation, ``steps.make_train_step``). One micro-step runs,
the one that applies the accumulated update, under :class:`MemoryTracker`, which follows
every storage that an operator allocates and frees and keeps the peak, split by
category. Its answer: the per-device peak of BASELINE config #4 (Gemma3-4B + ViT-L/384
full joint, fp32 masters and moments), whether it fits the card, and the collectives a
step pays by kind and phase (``distributed.COLLECTIVES``).

The tensors are fake CUDA tensors (``FakeTensorMode``) where torch has CUDA. Where it
has not (a CPU-only build), autograd refuses a fake CUDA tensor, and meta tensors stand
for the card: the kernels' wrappers take their card branch on both
(``kernels/_build.py:on_card``), allocate the buffers a launch writes and call the
``ptt`` operators, whose fake implementations launch and allocate nothing. The same
tracker over a real run of the same step gives the measured side (the CPU tests, the
smoke on the card). ``device='cpu'`` traces the CPU program (the kernels' plain
versions) on fake CPU tensors.

The card's bytes are the caching allocator's: each storage rounded up to 512 bytes.
``limit_bytes`` defaults to an H100's memory less the reserve a rank pays before its
first tensor (:data:`H100_USABLE_BYTES`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from projectiontrainer_tpu_torch.core.config import Stage2Config
from projectiontrainer_tpu_torch.core.pytree import unique_leaves_with_paths
from projectiontrainer_tpu_torch.models import decoder as dec
from projectiontrainer_tpu_torch.models import projector as proj
from projectiontrainer_tpu_torch.models import siglip, vlm
from projectiontrainer_tpu_torch.parallel import distributed, sharding

# NVIDIA H100 80GB HBM3 at 700.00 W: the card's memory (torch.cuda.mem_get_info), and the
# bytes a process holds there beside its allocator's before its first tensor of a model:
# the CUDA context, cuBLAS, the kernel library, Triton's module and a 1-rank NCCL
# communicator (chip_smoke.py phase 24, measure_reserve: the card's used memory grown over
# the process's start-up, less memory_reserved; NCCL over more ranks keeps more buffers,
# so this is a floor)
H100_TOTAL_BYTES = 85_017_493_504
H100_RESERVE_BYTES = 1_305_477_120
H100_USABLE_BYTES = H100_TOTAL_BYTES - H100_RESERVE_BYTES
ALLOCATOR_ROUND = 512  # the caching allocator's granule
CATEGORIES = ("params", "grads", "optimizer", "activations", "temporaries")


class MemoryTracker(TorchDispatchMode):
    """The bytes of live storages by category, and their peak, over what runs inside it.

    Every tensor an operator returns is charged to the category of the moment
    (:attr:`category`: what the budget sets; by default ``activations``, and
    ``temporaries`` inside autograd's backward) once per storage, rounded up to
    ``round_to`` bytes, and released when its storage is freed. Tensors made before the
    block are charged by :meth:`charge` (the params, the optimizer's state, the batch);
    :meth:`charge` moves a storage it already holds to another category (a gradient
    when the backward hands it over). ``torch.distributed._tools.mem_tracker.MemTracker``
    works the same way, but finds its categories through ``nn.Module`` and optimizer
    hooks, which a functional model does not reach."""

    def __init__(self, round_to: int = 1):
        super().__init__()
        self.round_to = round_to
        self.category: Optional[str] = None
        self.live = dict.fromkeys(CATEGORIES, 0)
        self.peak = 0
        self.at_peak = dict(self.live)
        self._held = WeakIdKeyDictionary()  # storage -> [category, bytes, weakref]

    def _bytes(self, st) -> int:
        n = st.nbytes()
        return -(-n // self.round_to) * self.round_to

    def charge(self, tensors, category: str) -> None:
        for t in tree_leaves(tensors):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            held = self._held.get(st)
            if held is None:
                held = [category, self._bytes(st), None]
                held[2] = weakref.ref(st, lambda _, h=held: self._release(h))
                self._held[st] = held
                self.live[category] += held[1]
            elif held[0] != category:
                self.live[held[0]] -= held[1]
                held[0] = category
                self.live[category] += held[1]
        total = sum(self.live.values())
        if total > self.peak:
            self.peak, self.at_peak = total, dict(self.live)

    def _release(self, held) -> None:
        self.live[held[0]] -= held[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        category = self.category
        if category is None:
            category = ("temporaries" if torch._C._current_graph_task_id() != -1
                        else "activations")
        new = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
               and t.untyped_storage() not in self._held]
        if new:
            self.charge(new, category)
        return out

    @contextlib.contextmanager
    def as_category(self, category: str):
        prev, self.category = self.category, category
        try:
            yield
        finally:
            self.category = prev


def small_test_config() -> vlm.VLMConfig:
    """The port's copy of the JAX package's ``small_test_vlm_cfg``: the budget's
    ``small-test`` preset, widths above the FSDP cut-off (``FSDP_MIN_SIZE``) so the
    gathers and reduce-scatters appear, head dim 32 in both towers."""
    vis = siglip.VisionConfig(hidden_size=128, intermediate_size=512, num_layers=2,
                              num_heads=4, image_size=32, patch_size=8)
    llm = dec.gemma3_config(vocab_size=4096, hidden_size=256, intermediate_size=768,
                            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=32,
                            sliding_window=16, query_pre_attn_scalar=32)
    return vlm.VLMConfig(vision=vis, llm=llm, projector=proj.ProjectorConfig(
        vision_dim=128, llm_dim=256, expansion_factor=4))


def trace_device(device: str) -> torch.device:
    """Where a trace of ``device`` runs: for ``cuda``, fake CUDA tensors where torch has
    CUDA and meta tensors (the card's stand-in) where it has not; ``meta`` asks for the
    stand-in anywhere; the CPU is itself."""
    if device not in ("cuda", "meta", "cpu"):
        raise ValueError(f"budget: device must be cuda, meta or cpu, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        return torch.device("meta")
    return torch.device(device)


def _empty_like_tree(shapes, device):
    """A tree of ``torch.empty`` leaves of ``shapes``' shapes and types on ``device``;
    a leaf held under two paths (the tied table) stays one tensor."""
    done = {}

    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in done:
            done[id(x)] = (x, torch.empty(x.shape, dtype=x.dtype, device=device))
        return done[id(x)][1]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(shapes)


@dataclasses.dataclass
class Program:
    """One rank's full-joint stage-2 program, built as ``Stage2Trainer`` builds it for
    epoch 0: the state (params, optimizer), the step, a batch and the shard plan."""

    state: dict
    step: object
    tx: object
    batch: dict
    plan: sharding.ShardPlan
    logits_chunk: Optional[int]


def build_program(vlm_cfg: vlm.VLMConfig, device, *, fake: bool, batch_per_device: int,
                  q_len: int, a_len: int, accum_steps: int, master_dtype: str, remat: str,
                  seed: int = 0) -> Program:
    """The program of rank 0 of the current world (its mesh set up), on ``device``:
    the trainer's own (``trainer_stage2.build_stage2``), its epoch-0 step. ``fake``:
    leaves without values (``torch.empty`` from the config's shapes; under
    ``FakeTensorMode`` or on the meta device); else random leaves and a random batch
    from ``seed``, to run for real. The step's next micro-step applies the update (the
    schedule's length, which moves no byte, is nominal)."""
    from projectiontrainer_tpu_torch.train.trainer_stage2 import build_stage2

    if fake:
        params = _empty_like_tree(vlm.init(torch.Generator(), vlm_cfg, device="meta"), device)
    else:
        params = vlm.init(torch.Generator(device=device).manual_seed(seed), vlm_cfg,
                          device=device)
    if distributed.model_size() > 1:  # the model rank's shards, as setup.build_vlm slices
        params = sharding.shard_params(params, sharding.plan_for(params, vlm_cfg),
                                       axes=(sharding.MODEL_AXIS,))
    # the stage-2 CLI's full-joint --fsdp options; the others are its defaults
    cfg = Stage2Config(batch_size=batch_per_device, gradient_accumulation_steps=accum_steps,
                       master_dtype=master_dtype, remat=remat, mixed_precision="bf16",
                       unfreeze_llm=True, unfreeze_projection_layer=True,
                       train_ve_first_epoch=True, fsdp=True)
    built = build_stage2(params, vlm_cfg, cfg, pad_id=0, total_steps=1000)
    step, tx, _ = built.steps[True]
    state = built.state
    state["opt_state"]["mini_step"] = accum_steps - 1
    b, img = batch_per_device, vlm_cfg.vision.image_size
    if fake:
        batch = {"pixel_values": torch.empty((b, img, img, 3), device=device),
                 "question_ids": torch.empty((b, q_len), dtype=torch.int64, device=device),
                 "answer_ids": torch.empty((b, a_len), dtype=torch.int64, device=device),
                 "sample_weight": torch.empty((b,), device=device)}
    else:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        vocab = vlm_cfg.llm.vocab_size
        batch = {"pixel_values": torch.rand((b, img, img, 3), generator=gen, device=device),
                 "question_ids": torch.randint(1, vocab, (b, q_len), generator=gen,
                                               device=device),
                 "answer_ids": torch.randint(1, vocab, (b, a_len), generator=gen,
                                             device=device),
                 "sample_weight": torch.ones((b,), device=device)}
    return Program(state=state, step=step, tx=tx, batch=batch, plan=built.plan,
                   logits_chunk=built.logits_chunk)


def state_tensors(state: dict) -> tuple[list, list]:
    """(the params' unique leaves, the optimizer's tensors) of a train state."""
    params = [x for _, x in unique_leaves_with_paths(state["params"])]
    opt = [x for v in state["opt_state"].values() if isinstance(v, dict) for x in v.values()]
    return params, opt


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def run_tracked(program: Program, tracker: MemoryTracker) -> dict:
    """Run the program's applying micro-step under ``tracker``: the params, the
    optimizer's state and the batch charged first; the backward's gradients of the
    trainable leaves charged as ``grads`` as they arrive; the optimizer's work as
    ``temporaries``. Returns the loss and the collectives of the micro-step."""
    params, opt = state_tensors(program.state)
    tracker.charge(params, "params")
    tracker.charge(opt, "optimizer")
    tracker.charge(list(program.batch.values()), "activations")
    hooks = []
    for _, x in unique_leaves_with_paths(program.state["params"]):
        if x.is_floating_point():
            x.requires_grad_(True)
            hooks.append(x.register_hook(lambda g: tracker.charge(g, "grads")))
    update = program.tx.update

    def tracked_update(*a, **kw):
        with tracker.as_category("temporaries"):
            return update(*a, **kw)

    program.tx.update = tracked_update
    distributed.reset_collectives()
    try:
        with tracker:
            _, loss, _ = program.step(program.state, program.batch, 0)
    finally:
        program.tx.update = update
        for h in hooks:
            h.remove()
    return {"loss": loss, "collectives": distributed.collective_inventory()}


def full_joint_budget(vlm_cfg=None, *, n_devices: int = 8, model_axis: int = 1,
                      batch_per_device: int = 4, q_len: int = 256, a_len: int = 1024,
                      accum_steps: int = 8, master_dtype: str = "fp32", remat: str = "full",
                      limit_bytes: Optional[int] = None, device: str = "cuda",
                      fake: bool = True, model: Optional[str] = None,
                      around_step=None) -> dict:
    """The per-device memory and collective budget of the full-joint ``--fsdp`` stage-2
    step (the epoch-0 variant: tower, projector and LLM all train) on rank 0 of a data x
    model mesh of ``n_devices`` ranks, traced without a card (module docstring).

    Defaults are the JAX function's, BASELINE config #4: Gemma3-4B + ViT-L/384, batch 4
    a data rank, the top (q 256, a 1024) bucket, fp32 masters, full remat, 8 ranks; the
    logits chunk is the trainer's (128 rows for vocabularies of 32768 or more). ``model`` names
    the config in the report (default: ``gemma3-4b`` for the default config). The
    report's keys mirror the JAX report's; ``per_device`` holds the peak and its split by
    category, ``fits`` replaces ``fits_16gb``, and ``oom`` is ``{used_bytes,
    limit_bytes, over_bytes}`` when the peak passes ``limit_bytes`` (default
    :data:`H100_USABLE_BYTES` on the card, None on the CPU); ``whole_units`` names the
    units that the model axis leaves whole on every rank (``sharding.check_config``: a
    model axis of 8 over Gemma3-4B's 4 KV heads replicates them).

    ``fake=False`` runs the same step for real on ``device`` (random leaves from a seed;
    the fake world's collectives still move nothing), under the same tracker: the
    measured side of the budget. ``around_step`` (a context manager factory) is entered
    around the micro-step alone, after the program is built (the smoke resets and
    reads the card's peak there)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if vlm_cfg is None:
        vlm_cfg, model = vlm.full_joint_4b_config(), model or "gemma3-4b"
    if n_devices % model_axis:
        raise ValueError(f"budget: {n_devices} devices do not hold a model axis of {model_axis}")
    on = trace_device(device) if fake else torch.device(device)
    t0 = time.perf_counter()
    with distributed.fake_world(n_devices, model=model_axis), \
            (FakeTensorMode() if fake else contextlib.nullcontext()):
        program = build_program(vlm_cfg, on, fake=fake, batch_per_device=batch_per_device,
                                q_len=q_len, a_len=a_len, accum_steps=accum_steps,
                                master_dtype=master_dtype, remat=remat)
        logits_chunk = program.logits_chunk
        params, opt = state_tensors(program.state)
        state_bytes = _nbytes(params) + _nbytes(opt)
        tracker = MemoryTracker(ALLOCATOR_ROUND if on.type != "cpu" else 1)
        with around_step() if around_step is not None else contextlib.nullcontext():
            ran = run_tracked(program, tracker)
        del program, params, opt
    if limit_bytes is None and on.type != "cpu":
        limit_bytes = H100_USABLE_BYTES
    peak = tracker.peak
    over = limit_bytes is not None and peak > limit_bytes
    img = vlm_cfg.vision.image_size
    return {
        "kind": "fake-trace" if fake else "tracked-run",
        "traced_on": on.type,
        "mesh": {"data": n_devices // model_axis, "model": model_axis},
        "model": model or "custom",
        "batch_global": batch_per_device * (n_devices // model_axis),
        "batch_per_device": batch_per_device,
        "seq": {"visual": (img // vlm_cfg.vision.patch_size) ** 2 - 1, "q": q_len, "a": a_len},
        "master_dtype": master_dtype,
        "remat": str(remat),
        "accum_steps": accum_steps,
        "logits_chunk": logits_chunk,
        "state_bytes_per_device": state_bytes,
        "limit_bytes": limit_bytes,
        "oom": ({"used_bytes": peak, "limit_bytes": limit_bytes,
                 "over_bytes": peak - limit_bytes} if over else None),
        "per_device": {"peak_bytes": peak, **{f"{k}_bytes": v
                                              for k, v in tracker.at_peak.items()}},
        "fits": None if limit_bytes is None else not over,
        "collectives": ran["collectives"],
        "whole_units": sharding.check_config(vlm_cfg, model_axis),
        "trace_s": time.perf_counter() - t0,
    }
