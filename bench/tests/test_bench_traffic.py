"""The mixes' generators repeat exactly from a seed."""
from __future__ import annotations

import json

import numpy as np
import torch

from bench.drivers.serve import Requests, _length
from bench.drivers.train import Feed
from bench_fixtures import ROOT

GEN = json.loads((ROOT / "bench/traffic/gen.json").read_text())
TRAIN = json.loads((ROOT / "bench/traffic/train.json").read_text())
BIG = 2**31 + 12345            # seeds go past 32 signed bits


def _draw(seed: int, n: int):
    req = Requests(GEN, seed, 49155)
    return [req.next() for _ in range(n)]


def test_gen_repeats_from_a_seed():
    a, b = _draw(BIG, 80), _draw(BIG, 80)
    for x, y in zip(a, b):
        assert x.rid == y.rid and x.max_new_tokens == y.max_new_tokens
        assert np.array_equal(x.prompt, y.prompt)
    c = _draw(BIG + 1, 80)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_gen_lengths_follow_the_laws():
    reqs = _draw(7, 2000)
    lens = np.array([len(r.prompt) for r in reqs])
    assert lens.min() >= 16 and lens.max() <= 602
    out = np.array([r.max_new_tokens for r in reqs])
    assert out.min() >= 32 and out.max() <= 1280
    # the published ShareGPT means (Kwon et al., SOSP 2023, Fig. 11a)
    assert abs(lens.mean() / 161.31 - 1) < 0.02
    assert abs(out.mean() / 337.99 - 1) < 0.02
    # log-uniform: the median near sqrt(16 * 602) = 98
    assert 88 < np.median(lens) < 110
    # every prompt fits the cache with its whole answer
    assert (lens + out.max()).max() <= GEN["cache_positions"]
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 49155


def test_gen_seeds_serve_the_same_sizes():
    """Every seed sends the same lengths in the same order; the seed
    draws the token ids."""
    a, b = _draw(11, 300), _draw(2**31 + 5, 300)
    assert [(len(x.prompt), x.max_new_tokens) for x in a] == [
        (len(y.prompt), y.max_new_tokens) for y in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


def test_length_laws_reach_both_ends():
    law = {"law": "uniform", "min": 1, "max": 4}
    assert [_length(law, u) for u in (0.0, 0.26, 0.51, 0.99)] == [1, 2, 3, 4]
    law = {"law": "log_uniform", "min": 64, "max": 512}
    assert _length(law, 0.0) == 64 and _length(law, 0.9999999) == 512


def test_train_feed_repeats_from_a_seed():
    a = Feed(TRAIN, 32000, BIG, "cpu")
    b = Feed(TRAIN, 32000, BIG, "cpu")
    for _ in range(3):
        x, y = a.next(), b.next()
        assert torch.equal(x["tokens"], y["tokens"])
        assert x["tokens"].shape == (TRAIN["batch"], TRAIN["seq_len"])
        assert torch.equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    c = Feed(TRAIN, 32000, BIG + 1, "cpu").next()
    assert not torch.equal(c["tokens"], Feed(TRAIN, 32000, BIG, "cpu"
                                             ).next()["tokens"])
    # every step's rows differ
    f = Feed(TRAIN, 32000, 3, "cpu")
    assert not torch.equal(f.next()["tokens"], f.next()["tokens"])
