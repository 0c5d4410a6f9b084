"""Build, check and time the fused linear + cross-entropy kernels on the card.

    python -m projectiontrainer_tpu_torch.kernels.check_fused_ce [--ptxas] [--time]

Needs an NVIDIA GPU and ``nvcc``. Prints one JSON line per step:

- ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``csrc/fused_ce.cu`` (registers, spills,
  shared memory of each kernel);
- always: the forward's lse / nll and the backward's dh (and its softmax part alone)
  against the plain versions at several shapes, ragged ones among them, with the
  tolerances of ``chip_smoke.py`` (1e-3 absolute; 2e-2 x max |reference|), and two
  reruns held bit-equal. Every shape is run before a failure is reported;
- ``--time``: at [2048, 1152] x [262144, 1152], median CUDA-event times of kernel,
  plain version and the library call (``F.linear`` + ``F.cross_entropy``, and its
  autograd backward to the hidden states), in turns.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops import fused_ce as CE

SHAPES = [(100, 1000, 128), (300, 5000, 256), (1, 128, 64), (127, 513, 192), (257, 1025, 1152),
          (64, 2000, 2560), (2048, 262144, 1152)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report() -> None:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           str(_build.BUILD_DIR / "ptxas_report.o"),
                           str(_build.CSRC / "fused_ce.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    name = None
    for line in proc.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        elif "registers" in line or "spill" in line or "warning" in line.lower():
            emit({"ptxas": name, "line": line.strip()})


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(n, v, d, seed=6):
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda").to(torch.bfloat16)

    h = bf16((n, d))
    w = (bf16((v, d)) * (5 / d ** 0.5)).contiguous()
    labels = torch.tensor(rng.integers(0, v, size=n), dtype=torch.int32, device="cuda")
    labels[0] = v - 1
    g = torch.tensor(rng.uniform(0.5, 1.5, size=n).astype(np.float32) / n,
                     device="cuda").to(torch.bfloat16).float()
    return h, w, labels, g


def check(n, v, d) -> bool:
    h, w, labels, g = inputs(n, v, d)
    lse, nll = CE.fused_ce_fwd(h, w, labels)
    rlse, rnll = CE.fused_ce_reference(h.float(), w.float(), labels)
    dh = CE.fused_ce_bwd(h, w, labels, rlse, g)
    torch.cuda.synchronize()
    rdh = CE.fused_ce_bwd_reference(h.float(), w.float(), labels, rlse, g)
    onehot = g[:, None] * w[labels.long()].float()
    lse2, nll2 = CE.fused_ce_fwd(h, w, labels)
    dh2 = CE.fused_ce_bwd(h, w, labels, rlse, g)
    row = {"shape": [n, v, d],
           "lse_err": float((lse - rlse).abs().max()), "nll_err": float((nll - rnll).abs().max()),
           "dh_rel": float((dh - rdh).abs().max() / rdh.abs().max()),
           "dh_softmax_rel": float((dh - rdh).abs().max() / (rdh + onehot).abs().max()),
           "bit_equal": bool(torch.equal(lse, lse2) and torch.equal(nll, nll2)
                             and torch.equal(dh, dh2))}
    row["ok"] = bool(row["lse_err"] <= 1e-3 and row["nll_err"] <= 1e-3 and row["dh_rel"] <= 2e-2
                     and row["dh_softmax_rel"] <= 2e-2 and row["bit_equal"])
    emit(row)
    return row["ok"]


def time_main_shape() -> None:
    n, v, d = 2048, 262144, 1152
    h, w, labels, g = inputs(n, v, d)
    lse, _ = CE.fused_ce_fwd(h, w, labels)
    long_labels = labels.long()

    def library_fwd():
        return F.cross_entropy(F.linear(h, w).float(), long_labels, reduction="none")

    hg = h.detach().requires_grad_(True)

    def library_fwd_bwd():
        nll = F.cross_entropy(F.linear(hg, w).float(), long_labels, reduction="none")
        return torch.autograd.grad(nll, hg, g)

    rows = {}
    for _ in range(2):  # in turns
        for name, fn in (("plain_fwd", lambda: CE.fused_ce_reference(h, w, labels)),
                         ("kernel_fwd", lambda: CE.fused_ce_fwd(h, w, labels)),
                         ("library_fwd", library_fwd),
                         ("plain_bwd", lambda: CE.fused_ce_bwd_reference(h, w, labels, lse, g)),
                         ("kernel_bwd", lambda: CE.fused_ce_bwd(h, w, labels, lse, g)),
                         ("library_fwd_bwd", library_fwd_bwd)):
            rows.setdefault(name, []).append(cuda_ms(fn))
    emit({"shape": [n, v, d], "ms": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--shapes", type=int, default=len(SHAPES), help="check the first K shapes")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if args.ptxas:
        ptxas_report()
    _build.library()
    emit({"build_s": _build.build_seconds})
    ok = [check(*shape) for shape in SHAPES[:args.shapes]]
    if args.time:
        time_main_shape()
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
