"""Build, check and time the LayerNorm backward (K8) on the card, without the rest of the
smoke run.

    python -m projectiontrainer_tpu_torch.kernels.check_layernorm [--ptxas] [--time] [--wide]

Needs an NVIDIA GPU and ``nvcc``. Prints one JSON line per step:

- ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``csrc/layernorm_bwd.cu`` (registers,
  spills, shared memory of each kernel, warnings);
- always: dx, dscale and dbias against the plain version (``layernorm_bwd_reference``
  evaluated in fp32 on the same inputs), each within 2e-2 x max |reference|, in one
  launch, at the stage-0 tower's rows ([16384, 1152]), at row counts whose bands end
  part-way through a ring stage (ragged, checked on a 132-SM card) or fill whole stages,
  at few rows (fewer CTAs than SMs), at the ViT-L tower's [4608, 1024], with fp32 rows,
  an fp32 scale, strided rows, D = 4096, rows that a bulk copy cannot take (D = 1001 and
  1004, 8-byte aligned strides, a base off 16 bytes: copied by cp.async) and D above
  4096 (6144, 8192; column sums through device memory) and rows too wide for one ring
  row (20480, 24577, 32768 and others: the streamed kernel); a rerun must give the same
  bits; then each refusal (another dtype, dy of another shape) must raise; at the widths
  above 16384 the LayerNorm forward (K2, looping over column chunks) against its plain
  version within atol = rtol = 2e-2 too. ``--wide``: only the widths above 19,368 (and
  K2 there). Every case is run before a failure is reported;
- ``--time``: device times (``utils/timing.py:device_ms``) of kernel, plain version,
  the library call (the autograd backward of ``F.layer_norm``: dx, dscale and dbias; a
  yardstick the port never calls) and ``torch.add(x, dy, out=dx)`` (the same bytes read
  and written with no arithmetic to speak of: what the card's memory gives one
  elementwise pass), in turns, at the shapes ``chip_smoke.py`` times; then the plan's
  alternatives in turns: one CTA against the grid at 16-32 rows, and 2-6 ring stages
  at [16384, 1152].
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.kernels.check_flash_attn import ptxas_report
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN
from projectiontrainer_tpu_torch.utils.timing import device_ms

TOL = 2e-2
# n, d, row dtype, scale dtype, row stride (None: contiguous), ragged on 132 SMs
CASES = [
    (16384, 1152, torch.bfloat16, torch.bfloat16, None, True),  # the stage-0 tower
    (16383, 1152, torch.bfloat16, torch.bfloat16, None, True),
    (1001, 1152, torch.bfloat16, torch.bfloat16, None, True),
    (1000, 1152, torch.bfloat16, torch.bfloat16, None, False),  # 125 bands of one stage
    (529, 1152, torch.bfloat16, torch.bfloat16, None, True),
    (16, 1152, torch.bfloat16, torch.bfloat16, None, False),    # the MAP head: one CTA
    (4608, 1024, torch.bfloat16, torch.bfloat16, None, True),   # the ViT-L tower
    (1, 1152, torch.bfloat16, torch.bfloat16, None, True),
    (1001, 1152, torch.float32, torch.bfloat16, None, True),    # fp32 rows: 3 stages
    (16384, 1152, torch.bfloat16, torch.float32, None, True),   # an fp32 scale
    (700, 1152, torch.bfloat16, torch.bfloat16, 1280, True),    # a slice of wider rows
    (4608, 4096, torch.bfloat16, torch.bfloat16, None, True),   # the widest D: 4 a stage
    (2000, 4096, torch.float32, torch.float32, None, True),     # 2 rows a stage
    (300, 64, torch.bfloat16, torch.bfloat16, None, True),
    (16384, 1004, torch.bfloat16, torch.bfloat16, None, True),  # rows of 2008 bytes: direct
    (16, 1001, torch.bfloat16, torch.bfloat16, None, False),    # odd D, one CTA
    (700, 1152, torch.bfloat16, torch.bfloat16, 1156, True),    # rows 8-byte aligned only
    (200, 1001, torch.float32, torch.float32, None, False),
    (1001, 1004, torch.float32, torch.bfloat16, None, True),    # bulk rows into 1008 slots
    (4096, 6144, torch.bfloat16, torch.bfloat16, None, True),   # wide: sums in device memory
    (2048, 8192, torch.bfloat16, torch.bfloat16, None, True),
    (3, 6144, torch.bfloat16, torch.bfloat16, None, True),      # wide, one CTA
    (300, 4104, torch.float32, torch.float32, None, True),
    (64, 4100, torch.bfloat16, torch.bfloat16, None, False),    # wide and direct
    # one ring row no longer fits: the streamed kernel
    (2048, 20480, torch.bfloat16, torch.bfloat16, None, False),  # chip_smoke.py's shapes
    (512, 32768, torch.bfloat16, torch.bfloat16, None, False),
    (1000, 24577, torch.bfloat16, torch.bfloat16, None, False),  # odd rows: element by element
    (2, 20480, torch.bfloat16, torch.bfloat16, None, False),     # one CTA
    (300, 20480, torch.float32, torch.float32, None, False),
    (140, 20480, torch.bfloat16, torch.float32, 20488, False),   # strided rows
]
STREAMED = [case for case in CASES if case[1] > 19368]
TIMED = [case for case in CASES if case[2] == case[3] == torch.bfloat16
         and case[4] is None and case[0] > 1][:7] + [CASES[14], CASES[19], CASES[20]]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def inputs(n, d, dtype, scale_dtype, stride, seed=4):
    rng = np.random.default_rng(seed)

    def tensor(shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                            device="cuda").to(torch.bfloat16)

    x = tensor((n, stride or d)).to(dtype)[:, :d]
    dy = tensor((n, d)).to(dtype)
    scale = (tensor((d,), 0.5) + 1).to(scale_dtype)
    return x, dy, scale


def rel_err(got, ref) -> float:
    return float((got.float() - ref).abs().max()) / float(ref.abs().max())


def check(n, d, dtype, scale_dtype, stride, ragged) -> bool:
    x, dy, scale = inputs(n, d, dtype, scale_dtype, stride)
    if n == 64 and d == 4100:  # a base that is not 16-byte aligned, too
        x = inputs(n, d + 4, dtype, scale_dtype, None)[0][:, 4:]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = FLN.bwd_plan(n, d, sms, x.element_size())
    before = FLN.bwd_launches.value
    got = FLN.layernorm_bwd(x, dy, scale, 1e-6)
    torch.cuda.synchronize()
    launched = FLN.bwd_launches.value == before + 1
    ref = FLN.layernorm_bwd_reference(x.float(), dy.float(), scale.float(), 1e-6)
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    again = [FLN.layernorm_bwd(x, dy, scale, 1e-6) for _ in range(2)]
    row = {"case": [n, d, str(dtype), str(scale_dtype), stride], **plan,
           "direct": FLN.bwd_direct(x, dy),
           "bands": sorted({c for _, c in FLN.bwd_bands(n, plan["ctas"])}),
           "ragged": FLN.bwd_ragged(n, plan), "rel_err_dx_dscale_dbias": errs,
           "finite": all(bool(a.isfinite().all()) for a in got),
           "bit_equal": all(torch.equal(a, b) for r in again for a, b in zip(got, r)),
           "launched_once": launched}
    row["ok"] = bool(max(errs) <= TOL and row["finite"] and row["bit_equal"] and launched
                     and (sms != 132 or row["ragged"] == ragged)
                     and (n >= plan["rows"] * sms or plan["ctas"] < sms))
    emit(row)
    return row["ok"]


def refusals() -> bool:
    """Each input the kernel does not take raises, and nothing is launched."""
    x = torch.zeros((64, 1160), dtype=torch.bfloat16, device="cuda")
    scale = torch.ones(1152, dtype=torch.bfloat16, device="cuda")
    cases = {
        "fp16 rows": (TypeError, (x[:, :1152].half(), x[:, :1152].half(), scale)),
        "dy of another shape": (ValueError, (x[:, :1152], x[:32, :1152], scale)),
        "fp16 scale": (TypeError, (x[:, :1152], x[:, :1152], scale.half())),
    }
    ok = True
    for name, (error, args) in cases.items():
        before = FLN.bwd_launches.value
        try:
            FLN.layernorm_bwd(*args, 1e-6)
            raised = None
        except (TypeError, ValueError) as e:
            raised = type(e)
        good = raised is error and FLN.bwd_launches.value == before
        emit({"refusal": name, "raised": raised.__name__ if raised else None, "ok": good})
        ok &= good
    return ok


def check_forward(n, d, dtype, scale_dtype, stride, ragged) -> bool:
    """K2 at the rows of a case against the plain forward, a rerun held bit-equal."""
    x, _, scale = inputs(n, d, dtype, scale_dtype, stride)
    p = {"scale": scale.to(dtype), "bias": (scale.float() * 0.1).to(dtype)}
    before = FLN.launches.value
    got = FLN.layernorm(p, x)
    torch.cuda.synchronize()
    ref = FLN.layernorm_reference({k: v.float() for k, v in p.items()}, x.float())
    err = (got.float() - ref).abs()
    row = {"forward": [n, d, str(dtype)], **FLN.fwd_plan(d), "max_abs_err": float(err.max()),
           "within_tol": bool((err <= TOL + TOL * ref.abs()).all() and got.isfinite().all()),
           "bit_equal": torch.equal(got, FLN.layernorm(p, x)),
           "launched": FLN.launches.value == before + 2}
    row["ok"] = row["within_tol"] and row["bit_equal"] and row["launched"]
    emit(row)
    return row["ok"]


def time_case(n, d, dtype, scale_dtype, stride, ragged) -> None:
    x, dy, scale = inputs(n, d, dtype, scale_dtype, stride)
    leaves = [x.detach().requires_grad_(True), scale.detach().requires_grad_(True),
              torch.zeros(d, dtype=dtype, device="cuda", requires_grad=True)]
    y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-6)
    out = torch.empty_like(x)
    rows = {}
    for _ in range(2):  # in turns
        for name, fn in (("plain", lambda: FLN.layernorm_bwd_reference(x, dy, scale, 1e-6)),
                         ("kernel", lambda: FLN.layernorm_bwd(x, dy, scale, 1e-6)),
                         ("library", lambda: torch.autograd.grad(y, leaves, dy,
                                                                 retain_graph=True)),
                         ("add", lambda: torch.add(x, dy, out=out))):
            rows.setdefault(name, []).append(device_ms(fn))
    bound_ms = 2 * (3 * n * d + 3 * d) / 3.35e12 * 1e3  # x, dy read, dx written; bytes
    emit({"case": [n, d], "device_ms": rows, "bound_ms": bound_ms,
          "library": "F.layer_norm backward (dx, dscale, dbias)"})


def time_plans() -> None:
    """The plan's choices against their alternatives, each checked against the plain
    version first and timed in turns."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alternatives = {}
    for n in (16, 24, 32):
        plan = FLN.bwd_plan(n, 1152, sms)
        alternatives[n] = {"one CTA": {**plan, "ctas": 1},
                           "grid": {**plan, "ctas": min(sms, -(-n // plan["rows"]))}}
    plan = FLN.bwd_plan(16384, 1152, sms)
    alternatives[16384] = {f"{s} stages": {**plan, "stages": s,
                                           "smem_bytes": FLN.bwd_smem_bytes(1152, 2, 8, s)}
                           for s in (2, 3, 4, 6)}
    for n, plans in alternatives.items():
        x, dy, scale = inputs(n, 1152, torch.bfloat16, torch.bfloat16, None)
        ref = FLN.layernorm_bwd_reference(x.float(), dy.float(), scale.float(), 1e-6)
        rows = {}
        for name, plan in plans.items():
            got = FLN.layernorm_bwd(x, dy, scale, 1e-6, plan=plan)
            rows[name] = {"plan": plan, "rel_err": [rel_err(a, b) for a, b in zip(got, ref)],
                          "ms": []}
        for _ in range(3):  # in turns
            for name, plan in plans.items():
                rows[name]["ms"].append(
                    device_ms(lambda: FLN.layernorm_bwd(x, dy, scale, 1e-6, plan=plan)))
        emit({"plans": [n, 1152], "chosen": FLN.bwd_plan(n, 1152, sms), **rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--wide", action="store_true", help="only the widths above 19,368")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if args.ptxas:
        ptxas_report(("layernorm_bwd.cu",))
    _build.library()
    emit({"build_s": _build.build_seconds})
    ok = [check(*case) for case in (STREAMED if args.wide else CASES)]
    ok += [check_forward(*case) for case in STREAMED if case[4] is None]
    ok.append(refusals())
    if args.time and args.wide:
        for case in STREAMED[:3]:
            time_case(*case)
    elif args.time:
        for case in TIMED:
            time_case(*case)
        time_plans()
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
