"""Step timing + throughput, and a profiler window over a train loop.

Counterpart of ``projectiontrainer_tpu/utils/timing.py``. ``StepTimer`` never forces a
device sync itself: the trainer opens a window before it asks the input feed for a
batch (``begin``; an eager PyTorch step spends much of its time on the host, unlike a
dispatched JAX program, and a stalled feed must show), counts steps, and closes the
window right after a real host-device sync (a ``float(loss)`` at a logging boundary);
the window's wall time is charged to the steps counted in it. The first window
(kernel builds, allocator warm-up) and windows holding a profiled step are excluded.
``StepProfiler`` maps ``jax.profiler`` to ``torch.profiler``: it captures steps
[start, start + num) into a Chrome trace under ``log_dir`` and splits their time over
the step's ``span``s (tower, projector, decoder, LM head + CE, optimizer), forward
and backward apart.
"""

from __future__ import annotations

import bisect
import os
import statistics
import time
from collections import defaultdict
from typing import Optional

import torch

SPAN = "span/"


def span(name: str):
    """A named piece of a train step: a ``torch.profiler.record_function`` range that
    ``span_times`` reads; it costs a few microseconds when no profiler runs."""
    return torch.profiler.record_function(SPAN + name)


def _outer(e):
    """(the span around e or None, e's outermost ancestor)"""
    name = None
    while True:
        if name is None and e.name.startswith(SPAN):
            name = e.name[len(SPAN):]
        if e.cpu_parent is None:
            return name, e
        e = e.cpu_parent


def _root_labels(cpu) -> dict:
    """id of each outermost CPU event -> ``<span>_fwd`` for a span, ``<span>_bwd`` for a
    backward node that differentiates ops of that span (matched by autograd sequence
    number, so a remat recompute counts to its layer's backward), ``other`` for the rest."""
    backward = "autograd::engine::evaluate_function"
    fwd = defaultdict(list)  # forward thread -> [(sequence number, span or None)]
    for e in cpu:
        if e.sequence_nr >= 0 and not e.fwd_thread:
            name, root = _outer(e)
            if not root.name.startswith(backward):  # not a remat recompute
                fwd[e.thread].append((e.sequence_nr, name))
    seqs = {}
    for thread, ops in fwd.items():
        ops.sort(key=lambda x: x[0])
        seqs[thread] = [s for s, _ in ops]

    labels = {}
    for e in cpu:
        if e.cpu_parent is not None:
            continue
        label = "other"
        if e.name.startswith(SPAN):
            label = f"{e.name[len(SPAN):]}_fwd"
        elif e.name.startswith(backward) and e.fwd_thread in fwd:
            i = bisect.bisect_right(seqs[e.fwd_thread], e.sequence_nr) - 1
            name = fwd[e.fwd_thread][i][1] if i >= 0 else None
            label = f"{name}_bwd" if name else "other"
        labels[e.id] = label
    return labels


def span_times(events, *, device: bool, steps: int = 1) -> dict:
    """Per-step milliseconds of each ``span`` in a profile's events: ``<name>_fwd_ms``
    for the ops inside the span, ``<name>_bwd_ms`` for the backward ops that
    differentiate them, ``other_ms`` for the rest and ``total_ms`` (their sum). A span
    inside another (``dequant`` inside ``decoder``) is reported apart as
    ``<outer>/<inner>_<fwd|bwd>_ms``, a part of ``<outer>_<fwd|bwd>_ms`` and not added
    to ``total_ms`` again (a remat recompute counts to the backward).
    ``device``: kernel time on the card (``device_time_total``), else host time."""
    attr = "device_time_total" if device else "cpu_time_total"
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    labels = _root_labels(cpu)
    out, total = defaultdict(float), 0.0
    for e in cpu:
        t = getattr(e, attr) / 1e3
        if e.cpu_parent is not None:
            if e.name.startswith(SPAN):
                label = labels[_outer(e)[1].id]
                if label != "other":
                    outer, where = label.rsplit("_", 1)
                    out[f"{outer}/{e.name[len(SPAN):]}_{where}_ms"] += t
            continue
        total += t
        out[f"{labels[e.id]}_ms"] += t
    out["total_ms"] = total
    return {k: v / steps for k, v in sorted(out.items())}


# kernel family -> fragments of the names of its kernels (the first family that matches)
KERNEL_FAMILIES = (
    ("attention", ("flash_fwd", "flash_bwd", "decode_attn")),
    ("fused_ce", ("fused_ce",)),
    ("layernorm", ("layernorm", "layer_norm")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet", "splitk", "wgmma")),
    ("reduce", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy", "catarray")),
)


def kernel_family(name: str) -> str:
    """attention, fused_ce, layernorm (the port's own kernels), matmul (the library's
    matrix products), reduce (sums, means and norms in plain torch), copy, or
    elementwise for everything else."""
    low = name.lower()
    for family, fragments in KERNEL_FAMILIES:
        if any(f in low for f in fragments):
            return family
    return "elementwise"


def kernel_families(events, *, steps: int = 1) -> dict:
    """Per-step milliseconds of the card's kernels by span and family:
    ``kernels/<span>_<fwd|bwd>/<family>_ms``, the spans as in ``span_times``."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    labels = _root_labels(cpu)
    out = defaultdict(float)
    for e in cpu:
        if e.kernels and not getattr(e, "is_legacy", False):
            label = labels[_outer(e)[1].id]
            for k in e.kernels:
                out[f"kernels/{label}/{kernel_family(k.name)}_ms"] += k.duration / 1e3
    return {k: v / steps for k, v in sorted(out.items())}


def device_ms(fn, *, launches: int = 10, groups: int = 3, hold_cycles: int = 40_000_000) -> float:
    """Milliseconds one ``fn()`` keeps the card busy: the median over ``groups`` of the
    CUDA-event time of ``launches`` calls divided by their number. Each group is queued
    behind a kernel that only spins for ``hold_cycles`` clocks (~20 ms), so the calls
    run back to back when it ends and the host's time to launch them (tens of
    microseconds a call from Python, more than a small kernel takes) is not in the
    reading. One warm-up call comes first."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


class StepTimer:
    def __init__(self, *, warmup_steps: int = 1):
        self.warmup_windows = warmup_steps
        self.reset()

    def reset(self):
        self._windows = 0
        self._steps = 0
        self._images = 0
        self._tokens = 0
        self._elapsed = 0.0
        self._pending_steps = 0
        self._pending_images = 0
        self._pending_tokens = 0
        self._discard = False
        self._t0: Optional[float] = None

    def begin(self):
        """Start the window's clock, unless it runs already: call before a step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def count(self, *, images: int = 0, tokens: int = 0, discard: bool = False):
        """Record one dispatched step's work items (call once per train step);
        ``discard`` drops the whole window (a profiled step runs slower)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._discard |= discard
        self._pending_steps += 1
        self._pending_images += images
        self._pending_tokens += tokens

    def window_end(self):
        """Close the current window: call right after a host-device sync."""
        if self._t0 is None or self._pending_steps == 0:
            self._t0 = None  # a window begun for a batch the feed did not have
            return
        dt = time.perf_counter() - self._t0
        self._windows += 1
        if self._windows > self.warmup_windows and not self._discard:
            self._elapsed += dt
            self._steps += self._pending_steps
            self._images += self._pending_images
            self._tokens += self._pending_tokens
        self._pending_steps = self._pending_images = self._pending_tokens = 0
        self._discard = False
        # the clock restarts at the next count(): time between windows (evaluation,
        # checkpoints, exports) is not charged to the next window's steps
        self._t0 = None

    @property
    def measured_steps(self) -> int:
        return self._steps

    def summary(self, *, n_devices: int = 1) -> dict:
        if self._steps == 0 or self._elapsed == 0:
            return {}
        out = {"steps_per_sec": self._steps / self._elapsed,
               "step_time_ms": 1e3 * self._elapsed / self._steps}
        if self._images:
            out["images_per_sec"] = self._images / self._elapsed
            out["images_per_sec_per_device"] = self._images / self._elapsed / n_devices
        if self._tokens:
            out["tokens_per_sec"] = self._tokens / self._elapsed
        return out


class StepProfiler:
    """``torch.profiler`` capture of a window of train steps (``--profile_dir``): CPU
    activity, and the card's kernels when CUDA is available; written to
    ``log_dir/trace_step{start}.json`` (Chrome trace format) on process 0 only. After
    the window, ``breakdown`` holds its ``span_times`` (kernel time on the card, host
    time without one) and, on the card, its ``kernel_families``."""

    def __init__(self, log_dir: Optional[str], *, start_step: int = 10, num_steps: int = 5,
                 rank: int = 0):
        self.log_dir = log_dir if rank == 0 else None
        self.start_step = start_step
        self.num_steps = num_steps
        self._prof = None
        self._stop_at: Optional[int] = None
        self._done = False
        self._steps = 0
        self.breakdown: dict = {}

    def step(self, global_step: int) -> bool:
        """Call once per train step with the current step index, before it runs, and
        once more after the last step; returns whether the step is captured."""
        if not self.log_dir or self._done:
            return False
        if self._prof is not None:
            self._steps = global_step - self._start  # the steps run since the capture began
            if global_step >= self._stop_at:
                self.close()
        elif global_step >= self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._start, self._stop_at = global_step, global_step + self.num_steps
            self._name = f"trace_step{global_step}.json"
        return self._prof is not None

    def close(self):
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir, self._name))
        events, steps = self._prof.events(), max(1, self._steps)
        self.breakdown = span_times(events, device=torch.cuda.is_available(), steps=steps)
        if torch.cuda.is_available():
            self.breakdown.update(kernel_families(events, steps=steps))
        self._prof = None
        self._done = True
