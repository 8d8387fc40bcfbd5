"""SSM and hybrid serving through the port: the continuous batcher and
the launcher.

The port's ``ContinuousBatcher`` on mamba2's and zamba2's ``SMOKE``
configs with the JAX package's parameters gives the JAX batcher's tokens
for 5 requests on 2 slots (``tests/test_batcher.py``'s overlap case), so
slots are refilled.  Admission must reset a slot's state: after each
prefill the slot's conv and SSM state (and the hybrid's attention rows)
are exactly the prompt's own, whatever the slot held before, and each
request's tokens equal greedy decoding of that request alone.
``repro_torch.launch.serve`` runs mamba2 at smoke size on the CPU.
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
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.batcher import Request as JRequest
except ImportError:
    jax = None

ARCHS = ("mamba2_2p7b", "zamba2_1p2b")


def _requests(vocab, cls):
    """5 requests of 4-8 tokens and 3-7 new tokens, as in
    ``tests/test_batcher.py``."""
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(4 + i,))
                .astype(np.int32), max_new_tokens=3 + i) for i in range(5)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_the_reference_batcher(arch):
    if jax is None:
        pytest.skip("needs JAX and the repro package")
    cfg = jconfigs.get_smoke(arch)
    jp = JM.init(cfg, jax.random.PRNGKey(1))
    tcfg = tconfigs.get_smoke(arch)
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jb = JBatcher(cfg, jp, n_slots=2, max_len=48)
    tb = ContinuousBatcher(tcfg, tp, n_slots=2, max_len=48, device="cpu")
    for jr, tr in zip(_requests(cfg.vocab_size, JRequest),
                      _requests(cfg.vocab_size, Request)):
        jb.submit(jr)
        tb.submit(tr)
    jdone = jb.run_to_completion()
    tdone = tb.run_to_completion()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.tokens == a.tokens, (a.rid, a.tokens, b.tokens)
        assert b.done and len(b.tokens) == b.max_new_tokens
    assert tb.prefills == 5 and tb.active == 0 and not tb.queue


class _Checked(ContinuousBatcher):
    """Checks after every admission that the slot holds exactly the
    state of the prompt's own prefill into a fresh B = 1 cache."""

    admissions = 0

    def _prefill(self, slot, req):
        dirty = self.cache["ssm"][:, slot].abs().sum() > 0
        super()._prefill(slot, req)
        one = TM.init_cache(self.cfg, 1, self.max_len, dtype=torch.float32,
                            device="cpu")
        TM.prefill(self.params, self.cfg, torch.from_numpy(req.prompt)[None],
                   one)
        names = ["conv", "ssm"] + (["attn"] if "attn" in one else [])
        for name in names:
            pool, fresh = self.cache[name], one[name]
            pairs = ([(pool[k], fresh[k]) for k in pool]
                     if isinstance(pool, dict) else [(pool, fresh)])
            for p, o in pairs:
                assert torch.equal(p[:, slot:slot + 1], o), (name, slot)
        self.admissions += 1
        self.refills = getattr(self, "refills", 0) + int(dirty)


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_resets_the_slot_state(arch):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init(cfg, 2, device="cpu")
    tb = _Checked(cfg, params, n_slots=2, max_len=48, device="cpu")
    reqs = _requests(cfg.vocab_size, Request)
    for r in reqs:
        tb.submit(r)
    done = tb.run_to_completion()
    assert tb.admissions == 5 and tb.refills == 3     # slots reused
    for r in done:                                    # greedy, alone
        cache = TM.init_cache(cfg, 1, 48, dtype=torch.float32, device="cpu")
        logits, cache = TM.prefill(params, cfg,
                                   torch.from_numpy(r.prompt)[None], cache)
        toks = [int(logits.argmax(-1))]
        while len(toks) < r.max_new_tokens:
            logits, cache = TM.decode_step(params, cfg,
                                           torch.tensor([toks[-1]]), cache)
            toks.append(int(logits.argmax(-1)))
        assert r.tokens == toks, r.rid


def test_serve_runs_mamba2_on_the_cpu(capsys):
    out = serve.main(["--arch", "mamba2_2p7b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "19", "--gen-len", "4"])
    assert out["device"] == "cpu" and out["config"] == "mamba2-smoke"
    assert out["tokens"].shape == (2, 4)
    assert "mamba2-smoke on cpu (host clock)" in capsys.readouterr().out
