"""LM serving through the port: the continuous batcher and the launcher.

The port's ``ContinuousBatcher`` on granite-3-2b's ``SMOKE`` config with
the JAX package's parameters gives the JAX batcher's tokens for the
prompts of ``tests/test_batcher.py`` (lengths 5, 9, 7, 4; 6 new tokens;
2 slots), and each request's tokens equal isolated greedy decoding
through ``prefill`` / ``decode_step`` (whose logits agree with the
reference within 1e-5 * max|logits|).  More requests than slots are
admitted as slots free up.  ``repro_torch.launch.serve`` runs at smoke
size on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.batcher import (ContinuousBatcher,  # noqa: E402
                                         Request)

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.batcher import Request as JRequest
except ImportError:
    jax = None

ARCH = "granite_3_2b"
TOL = 1e-5                           # relative to max|logits|


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


@pytest.fixture(scope="module")
def pair():
    _needs_jax()
    cfg = jconfigs.get_smoke(ARCH)
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke(ARCH)
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tcfg, tp


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in (5, 9, 7, 4)]


def test_batcher_matches_the_reference_batcher(pair):
    cfg, jp, tcfg, tp = pair
    prompts = _prompts(cfg.vocab_size)
    jb = JBatcher(cfg, jp, n_slots=2, max_len=64)
    tb = ContinuousBatcher(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    for i, p in enumerate(prompts):
        jb.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
        tb.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jdone = jb.run_to_completion()
    tdone = tb.run_to_completion()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.tokens == a.tokens, (a.rid, a.tokens, b.tokens)
        assert b.done and len(b.tokens) == 6
    assert tb.prefills == 4 and tb.active == 0 and not tb.queue


def test_batcher_equals_isolated_decoding_with_reference_logits(pair):
    """Each request of the batch is what greedy decoding alone gives,
    and those logits agree with the reference's step by step."""
    cfg, jp, tcfg, tp = pair
    prompts = _prompts(cfg.vocab_size)
    tb = ContinuousBatcher(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    for i, p in enumerate(prompts):
        tb.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    for req in tb.run_to_completion():
        tc = TM.init_cache(tcfg, 1, 64, dtype=torch.float32, device="cpu")
        jc = JM.init_cache(cfg, 1, 64, dtype=jnp.float32)
        tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(req.prompt)[None], tc)
        jl, jc = JM.prefill(jp, cfg, jnp.asarray(req.prompt)[None], jc)
        toks = []
        for _ in range(6):
            want = np.asarray(jl)
            err = float(np.abs(tl.numpy() - want).max())
            assert err <= TOL * float(np.abs(want).max())
            t = tl.argmax(-1)
            toks.append(int(t[0]))
            tl, tc = TM.decode_step(tp, tcfg, t, tc)
            jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t.numpy()), jc)
        assert req.tokens == toks, req.rid


def test_batcher_admits_and_retires_more_requests_than_slots():
    cfg = tconfigs.get_smoke(ARCH)
    params = TM.init(cfg, 1, device="cpu")
    tb = ContinuousBatcher(cfg, params, n_slots=2, max_len=48, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(5):
        tb.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=(4 + i,)).astype(np.int32),
            max_new_tokens=3 + i))
    produced = tb.step()             # two admitted, three queued
    assert produced == 2 and tb.active == 2 and len(tb.queue) == 3
    finished = tb.run_to_completion()
    assert sorted(r.rid for r in finished) == [0, 1, 2, 3, 4]
    assert [r.rid for r in finished][:2] == [0, 1]   # shortest budgets first
    for r in finished:
        assert len(r.tokens) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.tokens)
    assert tb.prefills == 5 and list(tb.lengths) == [0, 0]


def test_serve_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen-len", "4"])
    assert out["device"] == "cpu" and out["clock"] == "host clock"
    assert out["tokens"].shape == (2, 4)
    assert "granite3-smoke on cpu (host clock)" in capsys.readouterr().out
    # on a 2 x 1 mesh of the CPU: the same tokens
    on_mesh = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--gen-len", "4",
                          "--mesh-data", "2"])
    assert on_mesh["mesh"] == {"data": 2, "model": 1}
    assert np.array_equal(on_mesh["tokens"], out["tokens"])
