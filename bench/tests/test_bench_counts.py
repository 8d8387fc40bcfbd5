"""The frozen counts against cases worked out by hand."""
from __future__ import annotations

import pytest

from bench.counts import flops as FL
from bench.counts import kernels as K
from bench.counts import peaks


def test_flash_attention_by_hand():
    # q, o: 1 x 2 x 4 x 8; k, v: 1 x 1 x 4 x 8, bf16 -> 2 * 8 * (16 + 8);
    # causal pairs 1 + 2 + 3 + 4 = 10, 4 * 2 heads * 8 * 10
    assert K.flash_attention(1, 4, 4, 2, 1, 8, 2) == (384, 640)
    # not causal: every pair, 16
    assert K.flash_attention(1, 4, 4, 2, 1, 8, 2, causal=False)[1] == 1024
    # two queries at the end of four keys see 3 and 4 keys
    assert K.flash_attention(1, 2, 4, 1, 1, 1, 4)[1] == 4 * 7


def test_decode_attention_by_hand():
    # lengths 0 and 3: 1 + 4 live keys; q and out 2 * (2 * 2 * 4) bf16,
    # K and V 2 * 5 * 1 * 4 float32, the bias 2 * 8 float32
    assert K.decode_attention([0, 3], 8, 2, 1, 4, 2, 4) == (288, 160)


def test_fused_mlp_by_hand():
    # x, y 2 x 4, the norm 4, three 4 x 8 matrices, bf16; 6 * 2 * 4 * 8
    assert K.fused_mlp(2, 4, 8, 2) == (232, 384)


def test_bounds_spread_the_counted_calls_over_the_listed_ones():
    one_s_of_bytes, one_s_of_flops = (3.35e12, 0, 1.0), (0, 989e12, 989e12)
    listed = {"a": [one_s_of_bytes, one_s_of_flops], "c": [one_s_of_bytes]}
    # 4 calls over 2 listed of 1 s each; b not listed, c not counted
    assert K.bounds(listed, {"a": 4, "b": 2, "c": 0}) == {
        "a": pytest.approx(4.0)}


def test_peaks_and_bound():
    assert peaks.flops_for("bfloat16") == 989e12
    assert peaks.flops_for("float32") == 67e12
    with pytest.raises(KeyError):
        peaks.flops_for("int8")
    assert peaks.bound_s(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12, 989e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    from bench_fixtures import SMOKE_SIZES
    sz = SMOKE_SIZES["granite"]          # 2 layers, d 64, 4/2 heads of 16
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    assert FL.weights_per_token(sz) == 2 * (attn + 3 * 64 * 128) + 256 * 64
    # one token at position 3 attends to 4 positions in 2 layers
    assert FL.decode_flops(sz, [3]) == (2 * FL.weights_per_token(sz)
                                        + 2 * 4 * 4 * 16 * 4)
    assert FL.train_step_flops(sz, 2, 3) == 3 * 2 * FL.prompt_flops(sz, 3)


def test_weights_per_token_against_the_port():
    """The applied weights equal the port's parameter count without the
    norms' elements."""
    import json
    from bench_fixtures import ROOT
    from repro_torch.configs import get_config
    cfg = get_config("granite_3_2b")
    sz = json.loads((ROOT / "bench/configs/granite-3-2b.json").read_text()
                    )["sizes"]
    d, L = cfg.d_model, cfg.n_layers
    assert FL.weights_per_token(sz) == cfg.n_params() - (L * 2 * d + d)


def test_device_names_from_the_sources(tmp_path):
    (tmp_path / "k.cu").write_text(
        "template <int N>\n"
        "__global__ void __launch_bounds__(256, N > 1 ? 2 : 1)\n"
        "first_pass(const float* x) {}\n"
        "__global__ void second_pass(float* y) {}\n"
        "__device__ void helper(float* y) {}\n")
    names = K.device_names("k", tmp_path)
    assert names == ["first_pass", "second_pass"]
    pat = K.pattern(names)
    assert pat.search("void first_pass<2>(float const*)")
    assert not pat.search("void first_pass_b<2>(float const*)")
    assert K.device_names("missing", tmp_path) == []
    assert K.pattern([]) is None


def test_the_ports_kernels_have_device_names():
    from bench.harness.record import CSRC
    for k in ("flash_attention", "decode_attention", "fused_mlp"):
        assert K.device_names(k, CSRC), k
