"""The plain versions of the port's three kernels against the JAX package's Pallas
kernels run in interpret mode on the CPU, fp32, same numpy inputs; and the wrappers'
dispatch: a CPU tensor goes to the plain version, the kernel build raises when it
cannot build (no fallback).

The Pallas kernels are called directly: their dispatchers pick XLA whenever
``jax.device_count() != 1``, which is the case under this suite's 8-device conftest."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from projectiontrainer_tpu.ops import decode_attention as JDA
from projectiontrainer_tpu.ops import flash_attention as JFA
from projectiontrainer_tpu.ops import fused_layernorm as JFLN
from projectiontrainer_tpu_torch.kernels import _build
from projectiontrainer_tpu_torch.ops import decode_attention as DA
from projectiontrainer_tpu_torch.ops import flash_attention as FA
from projectiontrainer_tpu_torch.ops import fused_ce as CE
from projectiontrainer_tpu_torch.ops import fused_layernorm as FLN

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def test_layernorm_plain_matches_pallas():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 128), dtype=np.float32) * 2 + 0.5
    s = rng.standard_normal(128, dtype=np.float32)
    b = rng.standard_normal(128, dtype=np.float32)
    before = FLN.launches.value
    ours = FLN.layernorm({"scale": torch.tensor(s), "bias": torch.tensor(b)}, torch.tensor(x))
    assert FLN.launches.value == before  # a CPU tensor never reaches the kernel
    theirs = JFLN._fused_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-6, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


FLASH_CASES = {
    "tower": dict(hq=4, hkv=4, causal=False, window=None, pad=False),
    "prefill": dict(hq=4, hkv=1, causal=True, window=None, pad=True),
    "prefill_window": dict(hq=4, hkv=1, causal=True, window=9, pad=True),
    "gqa_window": dict(hq=4, hkv=2, causal=True, window=16, pad=False),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    c = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    b, t, d = 2, 40, 16
    q = rng.standard_normal((b, t, c["hq"], d), dtype=np.float32)
    k = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    v = rng.standard_normal((b, t, c["hkv"], d), dtype=np.float32)
    mask = None
    if c["pad"]:
        mask = np.ones((b, t), np.int32)
        mask[1, :13] = 0  # left padding: rows 0..12 of batch 1 have no valid key
    kw = dict(scale=d ** -0.5, causal=c["causal"], window=c["window"])
    before = FA.launches.value
    out, lse = FA.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  kv_mask=None if mask is None else torch.tensor(mask), **kw)
    assert FA.launches.value == before
    jmask = None if mask is None else jnp.asarray(mask)
    theirs = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_mask=jmask, interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), **TOL)
    _, jlse = JFA._fwd(*(jnp.asarray(x).swapaxes(1, 2) for x in (q, k, v)), jmask,
                       bq=JFA.DEFAULT_BQ, bk=JFA.DEFAULT_BK, interpret=True, **kw)
    live = np.ones((b, c["hq"], t), bool) if mask is None else np.broadcast_to(
        mask.astype(bool)[:, None, :], (b, c["hq"], t))
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[:, :, 0, :][live],
                               rtol=1e-5, atol=2e-5)
    if mask is not None:
        assert np.all(out.numpy()[1, :13] == 0)  # fully-masked rows are exactly zero


@pytest.mark.parametrize("t,window", [(0, None), (5, None), (11, 20), (11, 4)])
def test_decode_plain_matches_pallas(t, window):
    rng = np.random.default_rng(2)
    b, nb, hq, hkv, p, g, d = 2, 3, 4, 2, 24, 12, 16
    q = rng.standard_normal((b * nb, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((b, hkv, p, d), dtype=np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((b * nb, hkv, g, d), dtype=np.float32) for _ in range(2))
    pm = np.ones((b, p), np.int32)
    pm[1, :7] = 0
    kw = dict(t=t, prefix_len=p, scale=0.25, window=window)
    before = DA.launches.value
    ours = DA.decode_attention(*map(torch.tensor, (q, kp, vp, kg, vg)),
                               prefix_mask=torch.tensor(pm), **kw)
    assert DA.launches.value == before
    theirs = JDA._pallas_decode_attention(
        *map(jnp.asarray, (q, kp, vp, kg, vg)), jnp.asarray(pm), t, p, 0.25, window,
        interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit -> the build raises; nothing falls back to another implementation."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_kernel_build_raises_on_compile_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


def _c_signatures() -> dict:
    """name -> ctypes argument types of each ``extern "C"`` entry point in csrc/*.cu."""
    import ctypes
    import re

    def ctype(param):
        if "*" in param:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                "float": ctypes.c_float}[param.rsplit(" ", 1)[0].strip()]

    found = {}
    for src in _build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [ctype(" ".join(p.split())) for p in params.split(",")]
    return found


def test_build_signatures_match_the_c_entry_points():
    """Every C entry point has its ctypes signature, argument for argument (a pointer
    passed as a 32-bit int would be cut), among them K8's two."""
    assert {"layernorm_bwd_bf16", "layernorm_bwd_f32"} <= set(_build.SIGNATURES)
    assert _c_signatures() == _build.SIGNATURES


def test_launch_counter_counts_and_resets():
    c = _build.LaunchCounter("x")
    for _ in range(3):
        c.add()
    assert c.value == 3
    c.reset()
    assert c.value == 0


# ---- what Python decides about the fused CE kernels: the grid plan and the bounds


@pytest.mark.parametrize("vocab_tile", [CE.FWD_BV, CE.BWD_VW])
@pytest.mark.parametrize("v", [128, 262144, 262145])
@pytest.mark.parametrize("n", [1, 127, 2048, 2049])
def test_fused_ce_plan_covers_every_tile_once(n, v, vocab_tile):
    """The grid (token tiles of BM, splits) walks every (token tile, vocab tile) exactly
    once, as csrc/fused_ce.cu cuts it: split s takes vocab tiles [s * per, min((s + 1) *
    per, tiles)), none empty, and the scratch is indexed within [splits, n_pad]."""
    n_pad, splits, per = CE._plan(n, v, vocab_tile, sms=132)
    n_tiles, n_vt = -(-n // CE.BM), -(-v // vocab_tile)
    assert n_pad == n_tiles * CE.BM and n_pad >= n > n_pad - CE.BM
    seen = np.zeros((n_tiles, n_vt), np.int32)
    for tile in range(n_tiles):          # blockIdx.x
        for s in range(splits):          # blockIdx.y
            begin, end = s * per, min(n_vt, (s + 1) * per)
            assert begin < end, "an empty split"
            seen[tile, begin:end] += 1
            rows = tile * CE.BM + np.arange(CE.BM)
            assert (s * n_pad + rows < splits * n_pad).all()  # part[.., split, row]
    assert (seen == 1).all()
    assert n_tiles * splits <= max(132, n_tiles)  # one CTA per SM where the tokens allow it


def test_fused_ce_plan_fills_the_card_at_the_stage1_shape():
    assert CE._plan(2048, 262144, CE.FWD_BV, sms=132) == (2048, 8, 128)
    assert CE._plan(2048, 262144, CE.BWD_VW, sms=132) == (2048, 8, 64)


@pytest.mark.parametrize("name,args,want_ms,by", [
    ("bound_fused_ce_fwd", (2048, 262144, 1152), 1.25, "operations"),
    ("bound_fused_ce_bwd", (2048, 262144, 1152), 2.50, "operations"),
    ("bound_flash_fwd", (16, 1024, 16, 16, 72), 0.078, "operations"),
    ("bound_flash_bwd_dkv", (16, 1024, 16, 16, 72), 0.156, "operations"),
    ("bound_flash_bwd_dq", (16, 1024, 16, 16, 72), 0.117, "operations"),
    ("bound_layernorm_fwd", (16384, 1152), 0.0225, "bytes"),
    ("bound_layernorm_bwd", (16384, 1152), 0.0338, "bytes"),
    ("bound_decode_attn", (8, 3, 4, 1, 256, (8 * 831, 831, 32), 24 * 863), 0.0023, "bytes"),
    # head dim 2304, P = 300, window 100 at t = 15: 84 prefix and 16 generated slots live
    ("bound_decode_attn", (2, 3, 4, 1, 2304, (2 * 84, 84, 16), 6 * 100), 0.00079, "bytes"),
])
def test_chip_smoke_bounds(name, args, want_ms, by):
    """The bound calculators of chip_smoke.py (operations over 989 TFLOP/s, bytes over
    3.35 TB/s, the larger) at the main paths' shapes, within 2% of the hand-computed
    values (which are rounded to two or three digits)."""
    import chip_smoke

    ms, bound_by = getattr(chip_smoke, name)(*args)
    assert bound_by == by
    assert abs(ms - want_ms) <= 0.02 * want_ms


def test_chip_smoke_bound_takes_the_larger():
    import chip_smoke

    assert chip_smoke.bound(989e12, 0) == (1000.0, "operations")
    assert chip_smoke.bound(0, 3.35e12) == (1000.0, "bytes")
    assert chip_smoke.bound(989e9, 3.35e12)[1] == "bytes"


PTXAS_SPILLS = {  # what ptxas -v says of one kernel of each source: spill stores
    "flash_attn_cluster.cu": 0, "flash_attn_wide.cu": 294, "decode_attention.cu": 0,
    "layernorm_bwd.cu": 0}


@pytest.mark.parametrize("sources,fail_on,spilling,want", [
    # check_flash_attn --wide --ptxas: fails on the cluster kernels only
    (("flash_attn_cluster.cu", "flash_attn_wide.cu"), ("flash_attn_cluster.cu",), None, True),
    (("flash_attn_cluster.cu", "flash_attn_wide.cu"), ("flash_attn_cluster.cu",),
     "flash_attn_cluster.cu", False),
    # check_decode_attn / check_layernorm --ptxas: fail on any spill in their one source
    (("decode_attention.cu",), None, None, True),
    (("decode_attention.cu",), None, "decode_attention.cu", False),
    (("layernorm_bwd.cu",), None, None, True),
    (("layernorm_bwd.cu",), None, "layernorm_bwd.cu", False),
])
def test_ptxas_report_fails_on_a_spill(monkeypatch, tmp_path, capsys, sources, fail_on,
                                       spilling, want):
    """``check_flash_attn.ptxas_report`` (used by the three checkers' ``--ptxas``) returns
    and prints ``ok`` false where a source it is told to fail on spills, true otherwise;
    ptxas' output is given here, nvcc is not run."""
    import json
    import subprocess
    from types import SimpleNamespace

    from projectiontrainer_tpu_torch.kernels import check_flash_attn as CF

    def fake_run(cmd, **_):
        source = cmd[-1].rsplit("/", 1)[-1]
        spill = 128 if source == spilling else PTXAS_SPILLS[source]
        return SimpleNamespace(returncode=0, stdout="", stderr=(
            "ptxas info    : Compiling entry function 'kernel' for 'sm_90a'\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            "ptxas info    : Used 255 registers, used 1 barriers\n"))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(CF._build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(CF._build, "BUILD_DIR", tmp_path)
    assert CF.ptxas_report(sources, fail_on=fail_on) is want
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["ok"] is want
    assert set(last["ptxas_spill_bytes"]) == set(sources)
