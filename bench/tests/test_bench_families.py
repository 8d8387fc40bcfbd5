"""A model family is a name: granite's ``dense`` family reads exactly as
it did before it moved into files of its own, a family that exists only
as two registered modules runs through the reference, the counts and
both drivers' bounds, and an unknown name fails where the cell loads."""
from __future__ import annotations

import hashlib
import json
import math
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from bench import families
from bench.counts import flops as FL
from bench.counts import kernels as K
from bench.counts import peaks
from bench.drivers import serve, train
from bench.harness import cell as C
from bench.harness.cell import reader
from bench.reference import check
from bench.reference import model as R
from bench.reference.weights import flat, leaves, make_weights
from bench_fixtures import ROOT, SMOKE_SIZES, SMOKE_TRAIN, smoke_cell

SEED = 2**31 + 321
PINS = ROOT / "bench/tests/granite_pins.json"


# ----------------------------------------------------------------------
# granite reads as before
# ----------------------------------------------------------------------
def _sha(t: torch.Tensor) -> str:
    b = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()[:32]


def _ids(n, shape, seed):
    return torch.randint(0, n, shape,
                         generator=torch.Generator().manual_seed(seed))


def _weights() -> dict:
    out = {}
    for dtype in ("float32", "bfloat16"):
        sz = {**SMOKE_SIZES["granite"], "dtype": dtype}
        out[dtype] = {"/".join(p): _sha(t)
                      for p, t in flat(make_weights(sz, SEED, "cpu"))}
    return out


def _reference() -> dict:
    sz = SMOKE_SIZES["granite"]
    V = sz["vocab_size"]
    params = make_weights(sz, SEED, "cpu")
    seq = _ids(V, (40,), 7)
    out = {"logits": _sha(R.logits(params, sz, seq)),
           "logits_fp8": _sha(R.logits(params, sz, seq, prec="fp8"))}
    for p in (t for _, t in flat(params)):
        p.requires_grad_(True)
    ids = _ids(V, (2, 13), 8)
    with R.exact_matmul():
        loss = R.loss(params, sz, ids[:, :-1], ids[:, 1:])
        grads = torch.autograd.grad(loss, [t for _, t in flat(params)])
    out["loss"] = float(loss.detach())
    out["grads"] = {"/".join(p): _sha(g)
                    for (p, _), g in zip(flat(params), grads)}
    for p in (t for _, t in flat(params)):
        p.requires_grad_(False)
    greedy = R.logits(params, sz, seq, start=7).argmax(1).tolist()
    requests = [(seq[:8].tolist(), greedy[:20]),
                (seq[:5].tolist(), _ids(V, (30,), 9).tolist())]
    out["served_gap"] = check.served_gap(params, sz, requests, "cpu")
    out["control_gap"] = check.control_gap(params, sz, requests, "cpu")
    out["altered_gap"] = check.altered_gap(params, sz, requests, "cpu", SEED)
    batches = []
    for k in range(3):
        b = _ids(V, (2, 9), 10 + k)
        batches.append({"tokens": b[:, :-1], "labels": b[:, 1:]})
    adamw = SMOKE_TRAIN["adamw"]
    ref = check.train_reference(sz, SEED, batches, adamw, "cpu")
    low = check.train_reference(sz, SEED, batches, adamw, "cpu", prec="fp8")
    out["train"] = {"loss": ref["loss"], "grad_norms": ref["grad_norms"],
                    "change_norms": ref["change_norms"],
                    "grad_sample": {k: _sha(v) for k, v in
                                    ref["grad_sample"].items()}}
    out["control"] = check.train_numbers(low, ref)
    return out


def _counts() -> dict:
    out = {}
    cells = {"smoke": (smoke_cell("granite", "gen"),
                       smoke_cell("granite", "train")),
             "full": (C.load("granite-3-2b.gen"),
                      C.load("granite-3-2b.train"))}
    for size, (gen, tr) in cells.items():
        sz, L = gen.sizes, gen.sizes["n_layers"]
        top = gen.traffic["cache_positions"] - 1
        lengths = [0, 5, top // 3, top]
        out[size] = {
            "weights_per_token": FL.weights_per_token(sz),
            "prompt_flops": [FL.prompt_flops(sz, S) for S in (1, 17, 602)],
            "decode_flops": FL.decode_flops(sz, lengths),
            "train_step_flops": FL.train_step_flops(
                sz, tr.traffic["batch"], tr.traffic["seq_len"])}
        admits = [
            {"s": 0.25, "lengths": [17, 100, 3], "profiled": True,
             "calls": {"flash_attention": 3 * L + 1, "fused_mlp": 3 * L,
                       "decode_attention": 0, "ssd_scan": 0}},
            {"s": 0.05, "lengths": [50], "profiled": False,
             "calls": {"flash_attention": L, "fused_mlp": L,
                       "decode_attention": 0, "ssd_scan": 0}}]
        decodes = [
            {"events": None, "lengths": lengths, "active": 3,
             "profiled": True,
             "calls": {"flash_attention": 0, "fused_mlp": L,
                       "decode_attention": L, "ssd_scan": 0}},
            {"events": None, "lengths": [n + 1 for n in lengths],
             "active": 4, "profiled": True,
             "calls": {"flash_attention": 0, "fused_mlp": 2 * L,
                       "decode_attention": L - 1, "ssd_scan": 0}},
            {"events": None, "lengths": lengths, "active": 3,
             "profiled": False,
             "calls": {"flash_attention": 0, "fused_mlp": L,
                       "decode_attention": L, "ssd_scan": 0}}]
        batcher = types.SimpleNamespace(admits=admits, decodes=decodes)
        grec = serve._record(gen, batcher, None, 2.5)
        calls = {"flash_attention": 4 * L, "fused_mlp": 4 * L - 3,
                 "decode_attention": 0, "ssd_scan": 0}
        trec = train._record(tr, None, calls, [0.7, 0.75, 0.72])
        out[size].update({
            "gen_flops": grec.host["flops"],
            "mfu.gen": reader("mfu.gen")(grec),
            "step_flops": trec.host["step_flops"],
            "mfu.train": reader("mfu.train")(trec),
            "bounds": {"gen": grec.bounds, "train": trec.bounds}})
    return out


def readings() -> dict:
    """Granite's weights, the reference's readings and the counts, at
    the smoke sizes (the counts also at full size): what the pins hold."""
    return {"seed": SEED, "weights": _weights(), "reference": _reference(),
            "counts": _counts()}


def _same(got, want, path=""):
    """Equal, but for a kernel's bounds: to 1e-12 relative (a list of
    equal bounds is summed where a product was taken)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif "/bounds/" in path:
        assert got == pytest.approx(want, rel=1e-12, abs=0), path
    else:
        assert got == want, path


def test_granite_reads_as_before():
    """The pins recorded before the family moved hold: each weight leaf's
    bytes; the reference's logits, loss and first gradients, and
    ``served_gap``, the control's gap, an altered token's, and the three
    checked training steps with their fp8 control; the FLOP counts,
    ``mfu.*`` and the kernels' bounds of fixed synthetic records."""
    want = json.loads(PINS.read_text())
    want.pop("about")
    _same(json.loads(json.dumps(readings())), want)


# ----------------------------------------------------------------------
# a family that is only two registered modules
# ----------------------------------------------------------------------
NAME = "gelu_first"      # no file of that name: the test registers it
AUX = 0.25               # each layer's term in the loss, at the start


def _gelu_reference() -> types.ModuleType:
    """Layer 0 a norm and one d x d projection (``first``, a top-level
    leaf); layers 1.. dense attention and a plain GELU MLP, stacked over
    n_layers - 1.  Each layer adds ``aux_weight`` x the mean of a norm's
    weight to the loss."""
    from bench.reference.families import dense
    from bench.reference.model import layer, linear, rmsnorm
    from bench.reference.weights import matrix, ones, stacked

    def leaves(sz):
        d, ff, L = sz["d_model"], sz["d_ff"], sz["n_layers"]
        attn = dense.leaves({**sz, "n_layers": L - 1})["blocks"]["attn"]
        mlp = stacked({"ln": ones(d), "w1": matrix(d, ff),
                       "w2": matrix(ff, d)}, L - 1)
        return {"blocks": {"attn": attn, "mlp": mlp},
                "first": {"ln": ones(d), "w": matrix(d, d)}}

    def block(params, sz, i, x, prec):
        if i == 0:
            p = params["first"]
            h = rmsnorm(x, p["ln"], sz["norm_eps"])
            return x + linear(h, p["w"], prec), sz["aux_weight"] * p[
                "ln"].mean()
        p = layer(params["blocks"], i - 1)
        x = dense.attention(p["attn"], sz, x, prec)
        m = p["mlp"]
        h = rmsnorm(x, m["ln"], sz["norm_eps"])
        x = x + linear(F.gelu(linear(h, m["w1"], prec)), m["w2"], prec)
        return x, sz["aux_weight"] * m["ln"].mean()

    mod = types.ModuleType(f"bench.reference.families.{NAME}")
    mod.leaves, mod.block = leaves, block
    return mod


def _gelu_mlp(T, d, f, esize):
    """The GELU MLP's call, a formula of the family's own: x, y, w1, w2;
    two products of T x d x f."""
    return esize * (2 * T * d + 2 * d * f), 4 * T * d * f


def _gelu_counts() -> types.ModuleType:
    from bench.counts.families import dense

    def weights_per_token(sz):
        d, ff, V, L = (sz["d_model"], sz["d_ff"], sz["vocab_size"],
                       sz["n_layers"])
        Hq, Hkv, hd = sz["n_heads"], sz["n_kv_heads"], dense.head_dim(sz)
        attn = 2 * d * Hq * hd + 2 * d * Hkv * hd
        return (L - 1) * (attn + 2 * d * ff) + d * d + V * d

    def attention_flops(sz, positions):
        return dense.attention_flops({**sz, "n_layers": sz["n_layers"] - 1},
                                     positions)

    def _mlp(sz, T):
        e = 2 if sz["dtype"] == "bfloat16" else 4
        return [(*_gelu_mlp(T, sz["d_model"], sz["d_ff"], e),
                 peaks.flops_for(sz["dtype"]))] * (sz["n_layers"] - 1)

    def _attn(sz):
        return {**sz, "n_layers": sz["n_layers"] - 1}

    def prefill_calls(sz, mix, S):
        return {"flash_attention": dense.prefill_calls(
            _attn(sz), mix, S)["flash_attention"], "gelu_mlp": _mlp(sz, S)}

    def decode_calls(sz, mix, lengths):
        return {"decode_attention": dense.decode_calls(
            _attn(sz), mix, lengths)["decode_attention"],
            "gelu_mlp": _mlp(sz, len(lengths))}

    def train_calls(sz, mix):
        return {"flash_attention": dense.train_calls(
            _attn(sz), mix)["flash_attention"],
            "gelu_mlp": _mlp(sz, mix["batch"] * mix["seq_len"])}

    mod = types.ModuleType(f"bench.counts.families.{NAME}")
    for fn in (weights_per_token, attention_flops, prefill_calls,
               decode_calls, train_calls):
        setattr(mod, fn.__name__, fn)
    return mod


@pytest.fixture
def gelu_family(monkeypatch):
    for f in families.files(NAME):
        assert not (ROOT / f).exists(), f
    monkeypatch.setitem(sys.modules, f"bench.reference.families.{NAME}",
                        _gelu_reference())
    monkeypatch.setitem(sys.modules, f"bench.counts.families.{NAME}",
                        _gelu_counts())
    return {**SMOKE_SIZES["granite"], "family": NAME, "n_layers": 3,
            "aux_weight": AUX}


def test_a_registered_family_runs_through_the_reference(gelu_family):
    sz = gelu_family
    d, ff, V = sz["d_model"], sz["d_ff"], sz["vocab_size"]
    shapes = {"/".join(p): s for p, s, _, _ in leaves(sz)}
    assert shapes["first/w"] == (d, d) and shapes["first/ln"] == (d,)
    assert shapes["blocks/mlp/w1"] == (2, d, ff)
    assert shapes["blocks/attn/wq"] == (2, d, d)
    params = make_weights(sz, SEED, "cpu")
    assert set(params) == {"blocks", "embed", "final_ln", "first"}
    seq = _ids(V, (88,), 2)
    greedy = R.logits(params, sz, seq, start=7).argmax(1).tolist()
    assert check.served_gap(params, sz, [(seq[:8].tolist(), greedy[:1])],
                            "cpu") == 0.0
    req = [(seq[:8].tolist(), seq[8:].tolist() + [0])]
    assert check.control_gap(params, sz, req, "cpu") > 0.0
    assert check.altered_gap(params, sz, req, "cpu", 4) > 0.0

    batches = []
    for k in range(3):
        b = _ids(V, (2, 9), 20 + k)
        batches.append({"tokens": b[:, :-1], "labels": b[:, 1:]})
    adamw = SMOKE_TRAIN["adamw"]
    ref = check.train_reference(sz, SEED, batches, adamw, "cpu")
    # every layer's term is in the loss: AUX at ones, once a layer
    bare = check.train_reference({**sz, "aux_weight": 0.0}, SEED,
                                 batches[:1], adamw, "cpu")
    assert ref["loss"][0] - bare["loss"][0] == pytest.approx(
        3 * AUX, rel=1e-5)
    # and its gradient reaches the leaf it reads: AUX / d an element

    def first_ln_grad(s):
        p = make_weights(s, SEED, "cpu")
        w = p["first"]["ln"].requires_grad_(True)
        with R.exact_matmul():
            loss = R.loss(p, s, batches[0]["tokens"], batches[0]["labels"])
        return torch.autograd.grad(loss, w)[0]
    diff = first_ln_grad(sz) - first_ln_grad({**sz, "aux_weight": 0.0})
    torch.testing.assert_close(diff, torch.full_like(diff, AUX / d))
    assert set(ref["grad_norms"]) == {"/".join(p) for p, _ in flat(params)}
    low = check.train_reference(sz, SEED, batches, adamw, "cpu", prec="fp8")
    assert check.train_numbers(low, ref)["grad_diff"] > 0.0
    assert set(check.train_numbers(ref, ref).values()) == {0.0}


def test_a_registered_family_runs_through_the_counts(gelu_family):
    sz = gelu_family
    d, ff, V, Hq = (sz["d_model"], sz["d_ff"], sz["vocab_size"],
                    sz["n_heads"])
    hd, Hkv = d // Hq, sz["n_kv_heads"]
    attn = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
    N = 2 * (attn + 2 * d * ff) + d * d + V * d
    assert FL.weights_per_token(sz) == N
    assert FL.prompt_flops(sz, 5) == 2 * N * 5 + 2 * 4 * Hq * hd * 15
    assert FL.decode_flops(sz, [3, 0]) == 2 * (2 * N) + 2 * 4 * Hq * hd * 5
    assert FL.train_step_flops(sz, 2, 5) == 3 * 2 * FL.prompt_flops(sz, 5)


def test_a_registered_family_runs_through_both_drivers_bounds(gelu_family):
    """The calls as a CPU run's launch counters would read them on the
    card (they read 0 on the CPU), built by hand."""
    gen, tr = smoke_cell("granite", "gen"), smoke_cell("granite", "train")
    for c in (gen, tr):
        c.config = {**c.config, "family": NAME,
                    "sizes": {**c.config["sizes"], "n_layers": 3,
                              "aux_weight": AUX}}
    sz, mix = gen.sizes, gen.traffic
    assert sz["family"] == NAME
    d, ff, Hq, Hkv = sz["d_model"], sz["d_ff"], sz["n_heads"], sz["n_kv_heads"]
    bf = peaks.flops_for("float32")

    def b(n_bytes, n_flops, peak=bf):
        return peaks.bound_s(n_bytes, n_flops, peak)

    admits = [{"s": 0.1, "lengths": [9, 4], "profiled": True,
               "calls": {"flash_attention": 4, "gelu_mlp": 3,
                         "fused_mlp": 0}}]
    decodes = [{"events": None, "lengths": [0, 7, 63, 12], "active": 4,
                "profiled": True,
                "calls": {"decode_attention": 2, "gelu_mlp": 2}}]
    got = serve._bounds(gen, admits, decodes)
    want_flash = sum(2 * b(*K.flash_attention(1, S, S, Hq, Hkv, d // Hq, 4))
                     for S in (9, 4))
    want_mlp = (sum(1.5 * b(*_gelu_mlp(S, d, ff, 4)) for S in (9, 4))
                + 2 * b(*_gelu_mlp(4, d, ff, 4)))
    want_dec = 2 * b(*K.decode_attention([0, 7, 63, 12], 64, Hq, Hkv,
                                         d // Hq, 4, 4))
    assert set(got) == {"flash_attention", "gelu_mlp", "decode_attention"}
    assert got["flash_attention"] == pytest.approx(want_flash, rel=1e-12)
    assert got["gelu_mlp"] == pytest.approx(want_mlp, rel=1e-12)
    assert got["decode_attention"] == pytest.approx(want_dec, rel=1e-12)

    B, S = tr.traffic["batch"], tr.traffic["seq_len"]
    rec = train._record(tr, None, {"flash_attention": 8, "gelu_mlp": 6,
                                   "fused_mlp": 5}, [0.5])
    assert set(rec.bounds) == {"flash_attention", "gelu_mlp"}
    assert rec.bounds["flash_attention"] == pytest.approx(
        8 * b(*K.flash_attention(B, S, S, Hq, Hkv, d // Hq, 4)), rel=1e-12)
    assert rec.bounds["gelu_mlp"] == pytest.approx(
        6 * b(*_gelu_mlp(B * S, d, ff, 4)), rel=1e-12)
    assert rec.host["step_flops"] == FL.train_step_flops(sz, B, S)
    assert math.isfinite(reader("mfu.train")(rec))


# ----------------------------------------------------------------------
# a configuration names its family
# ----------------------------------------------------------------------
def _spec_with_family(tmp_path, family: str):
    config = json.loads((ROOT / "bench/configs/granite-3-2b.json"
                         ).read_text())
    config["family"] = family
    (tmp_path / "config.json").write_text(json.dumps(config))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"][0]["file"] = str(tmp_path / "config.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json"


def test_granite_names_its_family():
    cell = C.load("granite-3-2b.gen")
    assert cell.family == "dense" and cell.sizes["family"] == "dense"
    assert cell.config["sizes"]["family"] == "dense"     # the port's field


def test_an_unknown_family_fails_where_the_cell_loads(tmp_path):
    spec = _spec_with_family(tmp_path, "no_such_family")
    with pytest.raises(LookupError) as e:
        C.load("granite-3-2b.gen", spec)
    for f in ("bench/reference/families/no_such_family.py",
              "bench/counts/families/no_such_family.py"):
        assert f in str(e.value)


def test_a_registered_family_loads(tmp_path, gelu_family, monkeypatch):
    cell = C.load("granite-3-2b.train", _spec_with_family(tmp_path, NAME))
    assert cell.sizes["family"] == NAME
    # half a family is no family
    monkeypatch.delitem(sys.modules, f"bench.counts.families.{NAME}")
    with pytest.raises(LookupError, match="counts/families"):
        C.load("granite-3-2b.train", _spec_with_family(tmp_path, NAME))
