"""Generation in the port against the JAX package's ``generate`` on the tiny VLM, fp32
on the CPU: greedy and deterministic 3-beam decoding (repetition penalty, length
penalty, EOS, early stop) give IDENTICAL tokens from the same prefix. The sampled
paths draw from other random streams than JAX's, so they are checked for shapes and
flags only."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.generate import GenerationConfig as JGenerationConfig
from projectiontrainer_tpu.generate import decode as JD
from projectiontrainer_tpu.models import vlm as JVLM
from projectiontrainer_tpu_torch.checkpoint import from_jax
from projectiontrainer_tpu_torch.generate import GenerationConfig, decode as D, generate

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    jcfg = T.tiny_vlm_cfg()
    jparams = jax.tree.map(np.asarray, JVLM.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    q_ids = rng.integers(1, 128, size=(2, 9))
    q_ids[0, :4] = 0  # left padding
    embeds, mask = JVLM.question_prefix(jparams, jcfg, jnp.asarray(pixels),
                                        jnp.asarray(q_ids), pad_token_id=0)
    cfg = from_jax.config_from_jax(jcfg)
    params = from_jax.vlm_params(jparams)
    return dict(jcfg=jcfg, jp=jparams, cfg=cfg, p=params, embeds=np.asarray(embeds),
                mask=np.asarray(mask))


def _both(s, steps=False, **gen_kw):
    """(port tokens, JAX tokens) from the shared prefix; with ``steps`` the decode
    loops must also have taken the same number of steps."""
    if steps:
        fn = JD._generate_beam if gen_kw.get("num_beams", 1) > 1 else JD._generate_sample
        jout, jsteps = fn(s["jp"]["llm"], s["jcfg"].llm, jnp.asarray(s["embeds"]),
                          jnp.asarray(s["mask"]), JGenerationConfig(**gen_kw),
                          jax.random.key(0), with_stats=True)
    else:
        jout = JD.generate(s["jp"]["llm"], s["jcfg"].llm, jnp.asarray(s["embeds"]),
                           jnp.asarray(s["mask"]), JGenerationConfig(**gen_kw))
    tout = generate(s["p"]["llm"], s["cfg"].llm, torch.tensor(s["embeds"]),
                    torch.tensor(s["mask"]), GenerationConfig(**gen_kw), with_stats=steps)
    if steps:
        tout, tsteps = tout
        assert tsteps == int(jsteps)
    return tout.numpy(), np.asarray(jout)


def test_greedy_identical_tokens(setup):
    ours, theirs = _both(setup, max_new_tokens=12, repetition_penalty=1.8, pad_token_id=0)
    np.testing.assert_array_equal(ours, theirs)


def test_greedy_eos_early_exit(setup):
    probe, _ = _both(setup, max_new_tokens=16, pad_token_id=0)
    eos = int(probe[0, 2])
    ours, theirs = _both(setup, steps=True, max_new_tokens=16, eos_token_id=eos,
                         pad_token_id=0)
    np.testing.assert_array_equal(ours, theirs)


def test_beam_with_penalties_and_eos_identical_tokens(setup):
    kw = dict(max_new_tokens=12, num_beams=3, repetition_penalty=1.8, length_penalty=1.2,
              pad_token_id=0)
    probe, _ = _both(setup, **kw)
    eos = int(probe[0, 4])  # a token the search emits mid-sequence: finished set in use
    ours, theirs = _both(setup, steps=True, eos_token_id=eos, **kw)
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, probe)


@pytest.mark.parametrize("lp", [1.0, 2.0])
def test_beam_early_stop_identical_tokens_and_steps(setup, lp):
    kw = dict(max_new_tokens=16, num_beams=3, length_penalty=lp, pad_token_id=0)
    probe, _ = _both(setup, **kw)
    ours, theirs = _both(setup, steps=True, eos_token_id=int(probe[1, 1]), **kw)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_sampling_shapes_and_flags(setup, num_beams):
    s = setup
    cfg = GenerationConfig(max_new_tokens=10, do_sample=True, temperature=1.5, top_k=20,
                           top_p=0.9, repetition_penalty=1.8, num_beams=num_beams,
                           eos_token_id=5, pad_token_id=0)
    run = lambda seed: generate(s["p"]["llm"], s["cfg"].llm, torch.tensor(s["embeds"]),
                                torch.tensor(s["mask"]), cfg,
                                torch.Generator().manual_seed(seed)).numpy()
    a, b = run(0), run(0)
    assert a.shape == (2, 10)
    assert ((a >= 0) & (a < 128)).all()
    np.testing.assert_array_equal(a, b)  # one generator seed, one output
    for row in a:  # after an EOS only pad
        hits = np.flatnonzero(row == 5)
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    assert any(not np.array_equal(a, run(seed)) for seed in range(1, 6))


def test_top_p_filters_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 50), dtype=np.float32) * 3
    np.testing.assert_array_equal(D._top_p_filter(torch.tensor(logits), 0.8).numpy(),
                                  np.asarray(JD._top_p_filter(jnp.asarray(logits), 0.8)))
    srt = -np.sort(-logits, axis=-1)
    np.testing.assert_array_equal(D._top_p_on_sorted(torch.tensor(srt), 0.7).numpy(),
                                  np.asarray(JD._top_p_on_sorted(jnp.asarray(srt), 0.7)))


def test_repetition_penalty_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 30), dtype=np.float32)
    gen = np.array([[3, 3, 7, -1, -1], [0, 29, -1, -1, -1]])
    np.testing.assert_array_equal(
        D._apply_repetition_penalty(torch.tensor(logits), torch.tensor(gen), 1.8).numpy(),
        np.asarray(JD._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(gen), 1.8)))


def test_approx_top_k_raises(setup):
    """It no longer raises: the sampled beam search's candidate scan is the exact top-k
    under the flag too (XLA's ``approx_max_k`` off the TPU), so the flag changes no token
    under the same generator (tests/test_torch_approx_topk.py holds the rest)."""
    s = setup
    run = lambda flag: generate(
        s["p"]["llm"], s["cfg"].llm, torch.tensor(s["embeds"]), torch.tensor(s["mask"]),
        GenerationConfig(max_new_tokens=4, do_sample=True, top_k=5, num_beams=3,
                         approx_top_k=flag), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(run(True), run(False))


def test_port_imports_no_jax():
    """The port runs a tiny generate without JAX ever being imported."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from projectiontrainer_tpu_torch.models import decoder as dec\n"
        "from projectiontrainer_tpu_torch.generate import GenerationConfig, generate\n"
        "from projectiontrainer_tpu_torch.cli import serve, infer_vqa_stage2\n"
        "cfg = dec.gemma3_config(vocab_size=64, hidden_size=32, intermediate_size=64,\n"
        "                        num_layers=2, head_dim=16, sliding_window=4)\n"
        "p = dec.init(torch.Generator().manual_seed(0), cfg)\n"
        "emb = torch.randn(2, 5, 32)\n"
        "out = generate(p, cfg, emb, torch.ones(2, 5, dtype=torch.int32),\n"
        "               GenerationConfig(max_new_tokens=3, num_beams=3))\n"
        "assert out.shape == (2, 3)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
