"""The plain reference against itself, and its weights against the
port's parameter tree, at smoke sizes on the CPU."""
from __future__ import annotations

import pytest
import torch

from bench.reference import check
from bench.reference import model as R
from bench.reference.adamw import AdamW, lr_at
from bench.reference.weights import flat, iter_weights, leaves, make_weights
from bench_fixtures import SMOKE_SIZES, MODULES


@pytest.mark.parametrize("model", ["granite"])
def test_reference_is_causal(model):
    """A prefix's logits are the full sequence's at those positions: the
    reference sees no later token."""
    sz = SMOKE_SIZES[model]
    params = make_weights(sz, 5, "cpu")
    seq = torch.randint(0, sz["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(1))
    full = R.logits(params, sz, seq)
    part = R.logits(params, sz, seq[:23])
    torch.testing.assert_close(part, full[:23], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(R.logits(params, sz, seq, start=30),
                               full[30:])


@pytest.mark.parametrize("model", ["granite"])
def test_weights_are_the_ports_tree(model):
    """The benchmark's weights have the port's leaves, shapes and types,
    at the smoke size and, by shape alone, at full size."""
    import json
    from bench_fixtures import ROOT
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import model as M
    from repro_torch.models.layers import _leaves
    name = {"granite": "granite-3-2b"}[model]
    full = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    for sz, cfg in ((SMOKE_SIZES[model], get_smoke(MODULES[model])),
                    (full["sizes"], get_config(MODULES[model]))):
        ours = {p: shape for p, shape, _, _ in leaves(sz)}
        theirs = {p: d.shape for p, d in _leaves(M.param_defs(cfg))}
        assert ours == theirs
    ref = M.init(get_smoke(MODULES[model]), 0, device="cpu")
    got = make_weights(SMOKE_SIZES[model], 0, "cpu")

    def types(t, pre=()):
        if isinstance(t, dict):
            return {k: v for key in t for k, v in types(t[key], pre + (key,)
                                                        ).items()}
        return {pre: t.dtype}
    assert types(got) == types(ref)


def test_weights_repeat_and_iterate_in_order():
    sz = SMOKE_SIZES["granite"]
    a = make_weights(sz, 2**31 + 9, "cpu")
    b = make_weights(sz, 2**31 + 9, "cpu")
    for (p, x), (q, y) in zip(iter_weights(sz, 2**31 + 9, "cpu"), flat(b)):
        assert p == q and torch.equal(x, y), p
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"],
                           make_weights(sz, 2**31 + 10, "cpu")["embed"])


def test_fp8_control_is_coarser_and_passes_gradients():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    q = R.fp8_round(x)
    rel = float((q - x).detach().norm() / x.detach().norm())
    assert 1e-3 < rel < 0.1                 # e4m3: ~2^-4 steps
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


@pytest.mark.parametrize("model", ["granite"])
def test_fp8_reference_reads_above_f32(model):
    """The f32 reference's own greedy tokens read 0; the control (the
    reference in fp8) picks tokens that f32 ranks lower somewhere in 80
    positions, and an altered token reads above 0."""
    sz = SMOKE_SIZES[model]
    params = make_weights(sz, 3, "cpu")
    seq = torch.randint(0, sz["vocab_size"], (88,),
                        generator=torch.Generator().manual_seed(2))
    greedy = R.logits(params, sz, seq, start=7).argmax(1).tolist()
    assert check.served_gap(params, sz, [(seq[:8].tolist(), greedy[:1])],
                            "cpu") == 0.0
    req = [(seq[:8].tolist(), seq[8:].tolist() + [0])]
    assert check.control_gap(params, sz, req, "cpu") > 0.0
    assert check.altered_gap(params, sz, req, "cpu", 4) > 0.0


def test_adamw_schedule_and_first_step():
    cfg = {"lr_peak": 3e-4, "lr_min": 3e-5, "warmup_steps": 100,
           "decay_steps": 10000, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0}
    assert lr_at(cfg, 1) == pytest.approx(3e-6)
    assert lr_at(cfg, 100) == pytest.approx(3e-4)
    assert lr_at(cfg, 10000) == pytest.approx(3e-5)
    p = torch.tensor([1.0, -2.0, 0.5])
    opt = AdamW(cfg, [p])
    clipped = opt.apply([torch.tensor([3.0, 4.0, 0.0])])
    assert float(clipped[0].norm()) == pytest.approx(1.0, rel=1e-6)
    # step 1: m / sqrt(v) = sign(g), plus decay, times lr 3e-6
    want = torch.tensor([1.0, -2.0, 0.5]) - 3e-6 * (
        torch.tensor([1.0, 1.0, 0.0]) + 0.1 * torch.tensor([1.0, -2.0, 0.5]))
    torch.testing.assert_close(p, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("model", ["granite"])
def test_train_reference_against_itself(model):
    """Three steps from one seed repeat exactly; the loss starts near
    log(V) and every leaf moves."""
    import math
    sz = SMOKE_SIZES[model]
    gen = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(3):
        ids = torch.randint(0, sz["vocab_size"], (2, 9), generator=gen)
        batches.append({"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    cfg = {"lr_peak": 3e-4, "lr_min": 3e-5, "warmup_steps": 100,
           "decay_steps": 10000, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0}
    a = check.train_reference(sz, 1, batches, cfg, "cpu")
    b = check.train_reference(sz, 1, batches, cfg, "cpu")
    assert {k: v for k, v in a.items() if k != "grad_sample"} == {
        k: v for k, v in b.items() if k != "grad_sample"}
    assert all(torch.equal(a["grad_sample"][k], b["grad_sample"][k])
               for k in a["grad_sample"])
    assert abs(a["loss"][0] - math.log(sz["vocab_size"])) < 0.5
    assert all(v > 0 for v in a["change_norms"].values())
    nums = check.train_numbers(a, b)
    assert nums == {"loss_gap": 0.0, "grad_gap": 0.0, "grad_gap_median": 0.0,
                    "grad_diff": 0.0, "change_gap": 0.0}
    # a state left unchanged reads 1 by the change's measure
    still = {**a, "change_norms": {k: 0.0 for k in a["change_norms"]}}
    assert check.train_numbers(still, a)["change_gap"] == pytest.approx(1.0)
    # the sample holds the same places of the gradient: a gradient of
    # twice the size reads 1 on every leaf
    double = {**a, "grad_sample": {k: 2 * v for k, v in
                                   a["grad_sample"].items()}}
    assert check.train_numbers(double, a)["grad_diff"] == pytest.approx(1.0)
