"""The compiled decode step: ``CompiledStep`` and the serving paths that
decode through it (``ContinuousBatcher``, ``repro_torch.launch.serve``,
``examples/serve_lm_torch.py``).

On the CPU the step runs eagerly through the same static buffers and
pinned-staging logic (not pinned here): the batcher on the ``SMOKE``
configs of granite-3-2b, mamba2-2.7b, zamba2-1.2b, granite-moe-3b-a800m
and minicpm3-4b gives the JAX
batcher's tokens, and each step's logits within 1e-5 * max|logits|, for
5 requests on 2 slots (admissions and retirements between steps).  The
graph's bookkeeping runs on the CPU against a stand-in graph that
records a stub kernel at capture and runs it at replay: the launch
counts are the executed steps' (the capture counts nothing), a step's
state is written once a call, a returned result stays put at the next
replay, and a call with other shapes or types raises ``ValueError``.
``rope`` (its frequencies now built without a host-to-device copy)
agrees with the reference's within 1e-6.  ``launch.serve`` and the
example serve every config at its smoke size on the CPU, whisper-base
with its encoder's frames and internvl2-26b with its vision prefix;
what still refuses is pinned (a config past one card, a mesh).

Tests marked ``gpu`` capture the real step on the card: its logits equal
the eager step's bit for bit over 8+ steps with admissions and
retirements, one capture per batcher, the launch counters equal the
executed launches (and the profiler's kernel counts where it lists the
graph's kernels), and a step that reads the device on the host raises at
capture and returns nothing.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import compiled_step as CS  # noqa: E402
from repro_torch.runtime.batcher import (ContinuousBatcher,  # noqa: E402
                                         Request)

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.batcher import Request as JRequest
except ImportError:
    jax = None

ARCHS = ("granite_3_2b", "mamba2_2p7b", "zamba2_1p2b",
         "granite_moe_3b_a800m", "minicpm3_4b", "whisper_base",
         "internvl2_26b")
# the configs the batcher is held against the reference's batcher here:
# internvl2's (text-only) is in tests/test_torch_encdec_vlm.py, and a
# whisper request cannot be admitted (a Request carries no frames)
BATCHED = ARCHS[:5]
TOL = 1e-5                           # relative to max|logits|
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "serve_lm_torch.py"


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


def _requests(vocab, cls):
    """5 requests of 4-8 tokens and 3-7 new tokens on 2 slots: slots
    are refilled between steps (``tests/test_batcher.py``'s overlap)."""
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(4 + i,))
                .astype(np.int32), max_new_tokens=3 + i) for i in range(5)]


class _Recorded(ContinuousBatcher):
    """Keeps every decode step's logits, as returned."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.step_logits = []

    def _decode_step(self, tokens, lengths):
        logits, cache = super()._decode_step(tokens, lengths)
        self.step_logits.append(logits)
        return logits, cache


class _Eager(_Recorded):
    """The decode step called eagerly, as the batcher ran it before the
    step was captured: the yardstick of the graph on the card."""

    def _decode_step(self, tokens, lengths):
        cache = {**self.cache, "index": torch.tensor(lengths,
                                                     device=self.device)}
        token = torch.tensor(tokens, dtype=torch.long, device=self.device)
        logits, cache = TM.decode_step(self.params, self.cfg, token, cache)
        self.decode_steps += 1
        self.step_logits.append(logits)
        return logits, cache


# ----------------------------------------------------------------------
# on the CPU: the batcher against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", BATCHED)
def test_batcher_matches_the_reference_batcher_step_by_step(arch):
    _needs_jax()
    cfg = jconfigs.get_smoke(arch)
    jp = JM.init(cfg, jax.random.PRNGKey(2))
    tcfg = tconfigs.get_smoke(arch)
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jb = JBatcher(cfg, jp, n_slots=2, max_len=48)
    jlogits, jdecode = [], jb._decode

    def recorded(*a):
        out = jdecode(*a)
        jlogits.append(np.asarray(out[0]))
        return out
    jb._decode = recorded
    tb = _Recorded(tcfg, tp, n_slots=2, max_len=48, device="cpu")
    for jr, tr in zip(_requests(cfg.vocab_size, JRequest),
                      _requests(cfg.vocab_size, Request)):
        jb.submit(jr)
        tb.submit(tr)
    jdone = jb.run_to_completion()
    tdone = tb.run_to_completion()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.tokens == a.tokens, (a.rid, a.tokens, b.tokens)
    assert len(tb.step_logits) == len(jlogits) == tb.decode_steps >= 8
    for i, (got, want) in enumerate(zip(tb.step_logits, jlogits)):
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL * float(np.abs(want).max()), (i, err)
    step = tb.compiled
    assert not step.graphed and step.captures == 0
    assert step.steps == tb.decode_steps


def test_batcher_logits_stay_put_after_the_next_step():
    cfg = tconfigs.get_smoke("granite_3_2b")
    tb = _Recorded(cfg, TM.init(cfg, 3, device="cpu"), n_slots=2,
                   max_len=32, device="cpu")
    for r in _requests(cfg.vocab_size, Request)[:2]:
        tb.submit(r)
    tb.step()
    first = tb.step_logits[0]
    kept = first.clone()
    tb.step()
    assert torch.equal(first, kept)
    assert not torch.equal(tb.step_logits[1], kept)


# ----------------------------------------------------------------------
# on the CPU: the graph's bookkeeping, against a stand-in graph
# ----------------------------------------------------------------------
_RECORDING: list | None = None       # the stand-in graph being captured


def _stub(x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """A counted 'kernel' wrapper: adds x into ``state`` and returns
    state * 2.  Under a capture its work is recorded, not run; its
    Python counts one launch either way, as the real wrappers do."""
    out = torch.empty_like(state)

    def kernel():
        state.add_(x)
        torch.mul(state, 2, out=out)
    if _RECORDING is None:
        kernel()
    else:
        _RECORDING.append(kernel)
    _stub.launches += 1
    _stub.stub_launches += 1
    return out


_stub.launches = 0
_stub.stub_launches = 0


class _StandInGraph:
    def __init__(self):
        self.kernels = []

    def replay(self):
        for k in self.kernels:
            k()


class _StandInStep(CS.CompiledStep):
    """``CompiledStep`` with the CUDA calls replaced: the warm-up runs
    the step on the CPU and the capture records the stub's kernels."""

    def __init__(self, fn):
        super().__init__(fn, device="cpu", counters=(_stub,))
        self.graphed = True

    def _warm_up(self):
        return CS._copies(self.fn(*self._inputs))

    def _record(self):
        global _RECORDING
        graph = _StandInGraph()
        _RECORDING = graph.kernels
        try:
            out = self.fn(*self._inputs)
        finally:
            _RECORDING = None
        return graph, out


def test_launch_accounting_counts_executed_steps_not_the_capture():
    state = torch.zeros(3)
    step = _StandInStep(lambda x: (_stub(x, state), _stub(x, state)))
    _stub.launches = _stub.stub_launches = 0
    xs = [torch.full((3,), float(i + 1)) for i in range(5)]
    outs = []
    for i, x in enumerate(xs):
        outs.append(step(x))
        # two launches a step, each executed once: the capture at the
        # second call counts nothing and runs nothing
        assert _stub.launches == _stub.stub_launches == 2 * (i + 1)
        assert torch.equal(state, torch.full((3,), 2.0 * sum(
            range(1, i + 2))))
    assert step.captures == 1 and step.steps == 5
    assert step.step_launches == {"_stub": 2, "_stub.stub": 2}
    # each result is a copy: the replays after it left it as returned
    for i, (a, b) in enumerate(outs):
        total = 2.0 * sum(range(1, i + 2))
        assert torch.equal(a, torch.full((3,), 2 * (total - i - 1)))
        assert torch.equal(b, torch.full((3,), 2 * total))
    # counters reset between runs stay exact
    _stub.launches = 0
    step(xs[0])
    assert _stub.launches == 2 and step.captures == 1


def test_the_capture_runs_with_the_cycle_collector_off(monkeypatch):
    """A dead cycle is collected before the capture, none during it (a
    CUDA graph or pinned tensor freed inside a capture invalidates it),
    and the collector is back on after it, also when the step raises."""
    import gc
    import weakref

    class Graph:                       # stand-ins for the CUDA calls
        pass

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode=None):
        yield
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)

    class Node:
        pass
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        if x.sum() < 0:
            raise RuntimeError("the step failed")
        return x + 1

    step = CS.CompiledStep(fn, device="cpu", counters=())
    step._stream = None
    for x, fails in ((torch.ones(2), False), (-torch.ones(2), True)):
        cycle = Node()
        cycle.me = cycle
        dead = weakref.ref(cycle)
        del cycle
        step._inputs = (x,)
        if fails:
            with pytest.raises(RuntimeError):
                step._record()
        else:
            graph, out = step._record()
            assert isinstance(graph, Graph) and torch.equal(out, x + 1)
        assert dead() is None
        assert seen[-1] is False and gc.isenabled()


@pytest.mark.parametrize("bad", ["shape", "dtype"])
@pytest.mark.parametrize("graphed", [False, True])
def test_a_call_with_other_inputs_raises(bad, graphed):
    state = torch.zeros(4)
    fn = lambda x, i: (_stub(x, state), i + 1)  # noqa: E731
    step = (_StandInStep(fn) if graphed
            else CS.CompiledStep(fn, device="cpu", counters=(_stub,)))
    x, i = torch.ones(4), torch.zeros((), dtype=torch.int32)
    step(x, i)
    step(x, i)
    other = ((torch.ones(5), i) if bad == "shape"
             else (x, torch.zeros((), dtype=torch.int64)))
    with pytest.raises(ValueError, match="compiled for"):
        step(*other)
    assert step.steps == 2 and step.captures == int(graphed)


def test_a_step_must_return_tensors():
    step = CS.CompiledStep(lambda x: [x + 1], device="cpu")
    with pytest.raises(TypeError, match="tuple of tensors"):
        step(torch.ones(2))


# ----------------------------------------------------------------------
# on the CPU: rope, and the entry points
# ----------------------------------------------------------------------
@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("D", [64, 128])
def test_rope_matches_the_reference(D, theta):
    """Within 1e-6 * max|ref|: the two frameworks' ``pow`` differ by an
    ulp in a few frequencies, which position 300 scales up.  The
    frequencies equal those of the former tensor base bit for bit."""
    _needs_jax()
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    shared = np.arange(40, 45, dtype=np.int32)                 # (S,)
    per_seq = np.array([[7], [300]], dtype=np.int32)           # (B, 1)
    for pos, xs in ((shared, x), (per_seq, x[:, :1])):
        want = np.asarray(JL.rope(jnp.asarray(xs), jnp.asarray(pos), theta))
        got = TL.rope(torch.from_numpy(xs), torch.from_numpy(pos), theta)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), err
    ones = torch.ones(1, 1, 1, D)
    pos = torch.ones(1)              # the angles are the frequencies
    exps = -torch.arange(0, D // 2, dtype=torch.float32) / (D // 2)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    assert torch.equal(TL.rope(ones, pos, theta)[0, 0, 0, :D // 2],
                       torch.cos(freqs) - torch.sin(freqs))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decodes_eagerly_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen-len", "4"])
    assert out["decode_captured"] is False
    assert out["tokens"].shape == (2, 4)
    assert "eager" in capsys.readouterr().out


def _example():
    spec = importlib.util.spec_from_file_location("serve_lm_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_example_serves_the_ported_families_on_the_cpu(arch, capsys):
    out = _example().main(["--arch", arch, "--device", "cpu", "--batch",
                           "2", "--prompt-len", "6", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3) and not out["decode_captured"]
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_example_refuses_the_other_configs():
    """The example serves every config at its smoke size; what the
    launcher still refuses: a config past one card's memory at full size
    (qwen3-moe's 235 B parameters), also on a mesh that repeats one card.
    A mesh itself is served (whisper on 2 x 1 of the CPU)."""
    with pytest.raises(ValueError, match="model parallelism"):
        serve.main(["--arch", "qwen3_moe_235b_a22b", "--full",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="2x2 mesh over 1 device"):
        serve.main(["--arch", "qwen3_moe_235b_a22b", "--full",
                    "--device", "cpu", "--mesh-data", "2", "--mesh-model",
                    "2"])
    out = serve.main(["--arch", "whisper_base", "--device", "cpu",
                      "--mesh-data", "2", "--batch", "2", "--prompt-len",
                      "4", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3) and out["mesh"] == {"data": 2,
                                                             "model": 1}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card_batchers(arch, dtype, classes=(_Recorded, _Eager),
                   requests=_requests):
    """One batcher of each class on the card, with the same parameters
    and requests."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    params = TM.init(cfg, 4, device="cuda")
    made = []
    for cls in classes:
        b = cls(cfg, params, n_slots=2, max_len=48, device="cuda")
        for r in requests(cfg.vocab_size, Request):
            b.submit(r)
        made.append(b)
    return made


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in BATCHED]
                         + [(a, "bfloat16") for a in (
                             "granite_3_2b", "granite_moe_3b_a800m",
                             "minicpm3_4b")])
def test_graph_logits_equal_the_eager_step_on_card(arch, dtype):
    _needs_card()
    graph, eager = _card_batchers(arch, dtype)
    gdone, edone = graph.run_to_completion(), eager.run_to_completion()
    assert [r.tokens for r in gdone] == [r.tokens for r in edone]
    assert graph.decode_steps == eager.decode_steps >= 8
    err = max(float((a - b).abs().max())
              for a, b in zip(graph.step_logits, eager.step_logits))
    assert err == 0.0
    assert graph.compiled.captures == 1
    assert graph.compiled.steps == graph.decode_steps


@pytest.mark.gpu
def test_counters_equal_the_executed_launches_on_card():
    _needs_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.fused_mlp import fused_mlp
    def two_long(vocab, cls):           # no admission while profiled
        return [cls(rid=i, prompt=np.arange(5, dtype=np.int32) + i,
                    max_new_tokens=12) for i in range(2)]
    graph, = _card_batchers("granite_3_2b", "bfloat16", (_Recorded,),
                            two_long)
    L = graph.cfg.n_layers
    graph.step()
    graph.step()                               # warm-up, then capture
    torch.cuda.synchronize()
    assert graph.compiled.step_launches == {
        "decode_attention": L, "fused_mlp": L, "fused_mlp.stream": L}
    decode_attention.launches = fused_mlp.stream_launches = 0
    steps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            graph.step()
        torch.cuda.synchronize()
    assert decode_attention.launches == fused_mlp.stream_launches \
        == L * steps
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + 1

    def listed(key):
        return sum(n for name, n in by_name.items() if key in name)
    if listed("decode_split_kernel"):    # the profiler lists graph kernels
        assert listed("decode_split_kernel") == decode_attention.launches
        assert listed("mlp_stream_kernel") == fused_mlp.stream_launches


@pytest.mark.gpu
def test_a_host_read_fails_the_capture_on_card():
    _needs_card()
    x = torch.ones(8, device="cuda")

    def reads_the_host(t):
        return t * float((t + x).sum().item())

    step = CS.CompiledStep(reads_the_host, device="cuda")
    assert float(step(x).sum()) == 128.0           # the eager warm-up
    result = None
    with pytest.raises(RuntimeError):
        result = step(x)
    assert result is None and step.captures == 0 and step.steps == 1
    with pytest.raises(RuntimeError, match="capture failed"):
        step(x)
