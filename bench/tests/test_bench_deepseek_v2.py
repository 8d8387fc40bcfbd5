"""The deepseek_v2 family (deepseek-v2-lite): its weights as the port's
tree, the three gaps and a sound served run at the port's smoke size on
the CPU, its FLOP rules and kernel calls by hand, and the two readers
this configuration brought, on records built by hand."""
from __future__ import annotations

import dataclasses
import json
import types

import pytest
import torch

from bench.counts import flops as FL
from bench.counts import kernels as K
from bench.counts import peaks
from bench.counts.families import deepseek_v2 as DC
from bench.drivers import serve
from bench.harness.cell import Cell, load, reader
from bench.harness.record import CSRC, Record
from bench.harness.runner import run_cell
from bench.reference import check
from bench.reference import model as R
from bench.reference.weights import make_weights
from bench_fixtures import ROOT, SMOKE_GEN
from test_bench_spans import Ev, _kernel, _launch, _record, _span

SEED = 2**31 + 4099
NAME = "deepseek-v2-lite.gen"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FILE = json.loads((ROOT / "bench/configs/deepseek-v2-lite.json").read_text())


def _port_sizes() -> dict:
    """The file's sizes as the port's smoke config holds them."""
    from repro_torch.configs.deepseek_v2_lite import SMOKE
    return {k: getattr(SMOKE, k) for k in FILE["sizes"]}


def _smoke_sizes() -> dict:
    """The same, as the reference and the counts read them."""
    return {**_port_sizes(), "family": "deepseek_v2"}


def _cell(limits: dict | None = None) -> Cell:
    """The new cell at the port's smoke size under the smoke gen mix."""
    def applies(m):
        return "workloads" not in m or NAME in m["workloads"]
    return Cell(name=NAME, chips=1,
                config={"family": "deepseek_v2",
                        "port_module": "deepseek_v2_lite",
                        "port_attr": "SMOKE", "sizes": _port_sizes()},
                traffic=SMOKE_GEN, limits=limits or {},
                end_to_end=[m for m in SPEC["end_to_end"] if applies(m)],
                per_layer=[m for m in SPEC["per_layer"] if applies(m)])


def test_the_cell_loads_with_the_published_sizes():
    cell = load(NAME)
    assert cell.family == "deepseek_v2" and cell.chips == 1
    from bench.harness.cell import port_config
    cfg = port_config(cell.config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff,
            cfg.dense_d_ff) == (27, 2048, 64, 1408, 10944)
    assert FILE["reduced"] == [] and FILE["q_lora_rank"] is None
    assert FILE["num_hidden_layers"] == cfg.n_layers
    assert FILE["moe_intermediate_size"] == cfg.d_ff
    assert FILE["rope_scaling"]["factor"] == cfg.rope_factor
    names = {m["name"] for m in cell.per_layer}
    assert {"moe_experts_roofline.gen", "moe_prefill_ms.gen",
            "mfu.gen"} <= names


def test_make_weights_is_the_ports_tree():
    from repro_torch.configs.deepseek_v2_lite import SMOKE
    from repro_torch.models import model as M
    sz = _smoke_sizes()
    params = make_weights(sz, SEED, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    def defs(t):
        return {k: defs(v) if isinstance(v, dict) else v.shape
                for k, v in t.items()}
    assert shapes(params) == defs(M.param_defs(SMOKE))
    again = make_weights(sz, SEED, "cpu")
    assert torch.equal(params["blocks"]["mlp"]["wg"],
                       again["blocks"]["mlp"]["wg"])


def test_the_three_gaps():
    """The reference's own greedy tokens read 0; the fp8 control's first
    choices read above; one altered token reads above both."""
    sz = _smoke_sizes()
    params = make_weights(sz, SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    requests = []
    for n in (9, 14):
        seq = torch.randint(0, sz["vocab_size"], (n,), generator=g)
        for _ in range(12):
            nxt = R.logits(params, sz, seq, start=len(seq) - 1).argmax(1)
            seq = torch.cat([seq, nxt])
        requests.append((seq[:n].tolist(), seq[n:].tolist()))
    served = check.served_gap(params, sz, requests, "cpu")
    control = check.control_gap(params, sz, requests, "cpu")
    altered = check.altered_gap(params, sz, requests, "cpu", SEED)
    assert served < 1e-4
    assert control > served and altered > max(control, 0.1)


def test_a_sound_run_is_correct_and_an_altered_token_is_not(monkeypatch):
    limits = json.loads((ROOT / f"bench/limits/{NAME}.json").read_text())
    line = run_cell(_cell(limits), SEED, 0.6, False, torch.device("cpu"),
                    0.0)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"gen_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}
    from test_bench_harness import _alter_one_token
    _alter_one_token(monkeypatch)
    line = run_cell(_cell(limits), SEED, 0.6, False, torch.device("cpu"),
                    0.0)
    assert not line["correct"], line["checks"]


def test_the_flop_rules_by_hand():
    sz = {**FILE["sizes"], "family": "deepseek_v2"}
    d, H, r, kr, hd = 2048, 16, 512, 64, 128
    attn = d * H * (hd + kr) + d * (r + kr) + 2 * r * H * hd + H * hd * d
    moe = 3 * d * 1408 * (6 + 2) + d * 64
    N = 27 * attn + 3 * d * 10944 + 26 * moe + 102400 * d
    assert FL.weights_per_token(sz) == N == 2_451_308_544
    per = 27 * 2 * H * (2 * hd + kr)        # scores over 192, values 128
    assert FL.prompt_flops(sz, 5) == 2 * N * 5 + per * 15
    assert FL.decode_flops(sz, [3, 0]) == 2 * (2 * N) + per * 5


@pytest.mark.parametrize("T,reached", [(1, 6), (16, 50), (64, 63)])
def test_the_experts_a_call_reaches(T, reached):
    """``E (1 - (1 - K / E)^T)`` rounded down at 64 experts, top 6: one
    token reaches its 6; 16 tokens about 50.8; a decode step's 64 about
    63.9."""
    assert DC.experts_reached(T, 64, 6) == reached
    sz = {**FILE["sizes"], "family": "deepseek_v2"}
    n_bytes, n_flops = DC.moe_experts(T, sz)
    assert n_bytes == reached * 3 * 2048 * 1408 * 2 + T * 2048 * (2 + 4)
    assert n_flops == 6 * T * 6 * 2048 * 1408


def test_the_calls_of_a_prefill_and_a_decode_step():
    sz, mix = {**FILE["sizes"], "family": "deepseek_v2"}, SMOKE_GEN
    bf = peaks.flops_for("bfloat16")
    pre = DC.prefill_calls(sz, mix, 100)
    assert {k: len(v) for k, v in pre.items()} == {
        "flash_attention": 27, "fused_mlp": 27, "moe_experts": 26}
    assert pre["fused_mlp"][0] == (*K.fused_mlp(100, 2048, 10944, 2), bf)
    assert pre["fused_mlp"][1] == (*K.fused_mlp(100, 2048, 2816, 2), bf)
    q = 2 * 16 * 100 * (192 + 128)
    assert pre["flash_attention"][0] == (2 * q, 2 * 16 * 5050 * 320, bf)
    dec = DC.decode_calls(sz, mix, [9, 0, 30])
    live = 10 + 1 + 31
    assert dec["decode_attention"][0] == (
        2 * 3 * 16 * (512 + 576) + 4 * live * 576 + 4 * 3 * 64,
        2 * 16 * 1088 * live, peaks.flops_for("float32"))
    assert len(dec["moe_experts"]) == 26 and len(dec["fused_mlp"]) == 27
    with pytest.raises(ValueError):
        DC.train_calls(sz, mix)


def test_the_drivers_bounds_take_the_new_kernel():
    """A decode step's counted calls spread over the family's list."""
    cell = dataclasses.replace(_cell(), config={
        **_cell().config, "sizes": {**FILE["sizes"]}})
    decodes = [{"events": None, "lengths": [5, 9], "active": 2,
                "profiled": True,
                "calls": {"moe_experts": 26, "decode_attention": 27}}]
    got = serve._bounds(cell, [], decodes)
    sz = cell.sizes
    want = 26 * peaks.bound_s(*DC.moe_experts(2, sz), peaks.BF16_FLOPS)
    assert got["moe_experts"] == pytest.approx(want, rel=1e-12)
    assert set(got) == {"moe_experts", "decode_attention"}


def test_the_roofline_reader_on_a_trace_built_by_hand():
    """Every ``__global__`` of csrc/moe_experts.cu counts toward the
    kernel's time; other kernels do not."""
    names = K.device_names("moe_experts", CSRC)
    assert names == ["moe_combine_kernel", "moe_down_kernel",
                     "moe_gate_up_kernel"]
    trace = types.SimpleNamespace(window=(0.0, 1.0), device=[
        ("void (anonymous namespace)::moe_gate_up_kernel<1>(int)", 0.1, 0.3),
        ("void (anonymous namespace)::moe_down_kernel<1>(int)", 0.3, 0.4),
        ("void (anonymous namespace)::moe_combine_kernel(int)", 0.4, 0.45),
        ("void fused_mlp_tc_kernel<1>(int)", 0.5, 0.9)])
    rec = Record(sizes={}, traffic={}, trace=trace,
                 bounds={"moe_experts": 0.2})
    assert reader("moe_experts_roofline.gen")(rec) == pytest.approx(
        100 * 0.2 / 0.35)
    assert reader("moe_experts_roofline.gen")(
        Record(sizes={}, traffic={}, trace=trace)) is None


@pytest.mark.parametrize("typed", [True, False])
def test_the_moe_prefill_reader_on_a_profile_built_by_hand(typed):
    """Two prefills, the first with two MoE layers (two kernels under
    one span, one under the next), the second with one; a replay's
    kernels are under no MoE span, nor is a launch after the span's end:
    (0.03 + 0.02 + 0.03 + 0.04) ms over 2 prefills."""
    k = dict(typed=typed)
    events = [
        _span("bench.window", 0, 1_000_000),
        _span("batcher.prefill", 100_000, 300_000),
        _span("moe.layer", 110_000, 150_000),
        _launch(120_000, 1, typed), _kernel(130_000, 160_000, 1, **k),
        _launch(125_000, 2, typed), _kernel(160_000, 180_000, 2, **k),
        _span("moe.layer", 200_000, 250_000),
        _launch(210_000, 3, typed), _kernel(220_000, 250_000, 3, **k),
        _launch(260_000, 4, typed), _kernel(260_000, 290_000, 4, **k),
        _span("batcher.prefill", 400_000, 600_000),
        _span("moe.layer", 410_000, 450_000),
        _launch(420_000, 5, typed), _kernel(430_000, 470_000, 5, **k),
        _span("compiled.replay", 700_000, 710_000),
        Ev("cudaGraphLaunch", 705_000, 708_000, corr=6,
           activity="cuda_runtime" if typed else None),
        _kernel(720_000, 800_000, 6, **k),
    ]
    rec = _record(events)
    assert reader("moe_prefill_ms.gen")(rec) == pytest.approx(0.06)
    assert reader("moe_prefill_ms.gen")(_record(
        [e for e in events if e.name() != "moe.layer"])) is None


def test_the_new_readers_find_nothing_without_a_trace():
    rec = Record(sizes={}, traffic={})
    for m in ("moe_experts_roofline.gen", "moe_prefill_ms.gen"):
        assert reader(m)(rec) is None
