"""Continuous-batching serving scheduler (the port of
``repro.runtime.batcher``).

A fixed pool of decode *slots*; new requests are admitted into free
slots between steps and sequences retire on EOS or their length budget.
Each slot decodes against its own history length: the cache index is a
per-slot vector, so the attention bias masks each slot at its own
length and sequences of different ages share one batch.

As in the reference, prompts are prefilled one at a time (B = 1), decode
runs across all slots every step, and the host's lengths are the
scheduler's truth.  The reference prefills into a fresh cache and copies
its rows into the slot; here :func:`M.cache_slot` gives the slot's own
rows as a B = 1 cache of views (each leaf narrowed on the ``batch`` axis
that :data:`M.CACHE_AXES` declares), which admission zeroes and prefills
in place.  The reference jits the decode step once per batcher
(``jax.jit(self._decode_step)``); here a :class:`CompiledStep` captures
it once as a CUDA graph and replays it every step, so on the card a step
is one graph launch.  Its inputs, the tokens and the per-slot lengths,
are copied each step from pinned host tensors into the graph's static
buffers, and the cache's tensors keep their addresses for the batcher's
life (admission writes a slot in place).  On the CPU the step runs
eagerly through the same buffers.  Prefill stays eager and B = 1, as the
reference's is not jitted.

Tracing (:mod:`repro_torch.obs.tracer`; the process-global tracer, so
``$REPRO_TRACE`` switches it on): the spans ``batcher.admit`` around an
admission that prefills, with one ``batcher.prefill`` per request inside
it (ended by the first token's host read, which waits for the device),
``batcher.decode`` (the staging wait, the host copies and the compiled
step's call), ``batcher.sample`` (the argmax and its copy to the host)
and ``batcher.retire``; no span covers a whole step, so a device gap is
named by the phase the host was in.  Counters, each step:
``batcher.active`` and ``batcher.queued``.  Each request's ``queued`` ->
``prefill`` -> ``decode`` timeline is emitted at its retirement under an
id taken at ``submit``, from timestamps taken on the way.  While
``torch.profiler`` records, the spans also open its ranges, with or
without a tracer.

As in the reference, a request is its prompt alone: a ``vlm`` model
(internvl2) is served text-only, and an ``encdec`` model (whisper)
cannot be admitted, since a ``Request`` carries no encoder frames; its
prefill raises ``ValueError`` naming the missing ``enc_embeds`` (the
reference's fails inside its encoder).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.tracer import maybe_span, resolve_tracer
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.compiled_step import CompiledStep
from repro_torch.runtime.slots import SlotPool

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                   # -1: run to the length budget
    # filled by the batcher:
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching on top of prefill / decode.

    ``params`` must live on ``device`` (default: the card).  The cache is
    the stacked (layers, slots, ...) tree of :func:`M.init_cache`, in
    ``dtype`` (float32 by default, as in the reference).  ``compiled``
    is the decode step (:class:`CompiledStep`; ``compiled.captures`` is
    1 once two steps have run on the card).  ``tracer``: the
    process-global tracer at construction, if any.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int,
                 max_len: int, dtype: torch.dtype = torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.tracer = resolve_tracer(None)
        # id(request) -> [trace id, submit, prefill start, first token]
        self._timeline: dict[int, list] | None = (
            None if self.tracer is None else {})
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.cache = M.init_cache(cfg, n_slots, max_len, dtype=dtype,
                                  device=self.device)
        # per-slot sequence lengths (host copy is the scheduler truth)
        self.lengths = np.zeros(n_slots, np.int32)
        self.pool: SlotPool = SlotPool(n_slots)
        self.prefills = 0
        self.decode_steps = 0
        # each step's inputs, staged on the host: pinned on the card's
        # host, so their copies into the graph's buffers are async
        pin = self.device.type == "cuda"
        self._host_tokens = torch.zeros(n_slots, dtype=torch.long,
                                        pin_memory=pin)
        self._host_lengths = torch.zeros(n_slots, dtype=torch.int32,
                                         pin_memory=pin)
        # recorded after each step's copies out of staging
        self._staged = torch.cuda.Event() if pin else None
        self.compiled = CompiledStep(self._forward, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if self.tracer is not None:
            self._timeline[id(req)] = [self.tracer.new_id(),
                                       time.perf_counter(), None, None]
        self.pool.submit(req)

    @property
    def active(self) -> int:
        return self.pool.active

    @property
    def queue(self):
        return self.pool.queue

    @property
    def slot_req(self) -> list[Request | None]:
        return self.pool.slots

    @property
    def finished(self) -> list[Request]:
        return self.pool.finished

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Prefill queued requests into free slots (one at a time)."""
        admitted = self.pool.admit()
        if not admitted:
            return
        tr = self.tracer
        with maybe_span(tr, "batcher.admit", cat="batcher",
                        requests=len(admitted)):
            for slot, req in admitted:
                marks = (self._timeline.get(id(req)) if tr is not None
                         else None)
                if marks is not None:
                    marks[2] = time.perf_counter()
                with maybe_span(tr, "batcher.prefill", cat="batcher",
                                rid=req.rid, tokens=len(req.prompt)):
                    self._prefill(slot, req)
                if marks is not None:
                    marks[3] = time.perf_counter()

    def _prefill(self, slot: int, req: Request) -> None:
        """One request's B = 1 prefill, written in place into ``slot``'s
        views (:func:`M.cache_slot`), zeroed first: the rows past the
        prompt and any state a finished request left read zero, as in
        the reference's fresh cache.  Its first token is read back to
        the host."""
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None]
        view = M.cache_slot(self.cache, slot)
        for t in tree_leaves(view):
            t.zero_()
        logits, _ = M.prefill(self.params, self.cfg, prompt, view)
        req.tokens.append(int(torch.argmax(logits[0], -1)))
        self.lengths[slot] = len(req.prompt)
        self.prefills += 1

    # ------------------------------------------------------------------
    def _forward(self, token: torch.Tensor, index: torch.Tensor):
        """The step the graph holds: (logits, the advanced index)."""
        logits, cache = M.decode_step(self.params, self.cfg, token,
                                      {**self.cache, "index": index})
        return logits, cache["index"]

    def _decode_step(self, tokens: np.ndarray, lengths: np.ndarray):
        """One decode step with PER-SLOT lengths: each slot writes its KV
        at its own position and attends under its own mask."""
        if self._staged is not None:   # the last step's copies are done
            self._staged.synchronize()
        self._host_tokens.numpy()[:] = tokens
        self._host_lengths.numpy()[:] = lengths
        logits, index = self.compiled(self._host_tokens, self._host_lengths)
        if self._staged is not None:
            self._staged.record()
        self.decode_steps += 1
        return logits, {**self.cache, "index": index}

    def step(self) -> int:
        """Admit, decode once for all active slots, retire finished.

        Returns the number of tokens produced this step."""
        self._admit()
        tr = self.tracer
        if tr is not None:
            tr.counter("batcher.active", self.active)
            tr.counter("batcher.queued", len(self.queue))
        if self.active == 0:
            return 0
        tokens = np.zeros(self.n_slots, np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                tokens[i] = r.tokens[-1]
        # keep host lengths authoritative (the step +1s them all,
        # including idle slots; we install our own vector next step);
        # only the index changes, the other tensors stay the graph's
        with maybe_span(tr, "batcher.decode", cat="batcher"):
            logits, self.cache = self._decode_step(tokens, self.lengths)
        with maybe_span(tr, "batcher.sample", cat="batcher"):
            nxt = self._sample(logits)
        with maybe_span(tr, "batcher.retire", cat="batcher"):
            return self._retire(nxt)

    @staticmethod
    def _sample(logits: torch.Tensor) -> np.ndarray:
        """Each slot's greedy next token, on the host."""
        return torch.argmax(logits, -1).cpu().numpy().astype(np.int32)

    def _retire(self, nxt: np.ndarray) -> int:
        """Appends each live slot's next token, marks the finished and
        frees their slots; returns the tokens appended."""
        produced = 0
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.lengths[i] += 1
            r.tokens.append(int(nxt[i]))
            produced += 1
            over = len(r.tokens) >= r.max_new_tokens
            eos = r.eos_id >= 0 and int(nxt[i]) == r.eos_id
            if over or eos or self.lengths[i] >= self.max_len - 1:
                r.done = True
        # continuous refill: reap every finished sequence's slot; the next
        # _admit() backfills them without a drain barrier
        for slot in self.pool.ready(lambda r: r.done):
            req = self.pool.retire(slot)
            self.lengths[slot] = 0
            if self.tracer is not None:
                self._emit_timeline(req)
        return produced

    def _emit_timeline(self, req: Request) -> None:
        """The request's queued -> prefill -> decode timeline, one async
        track under the id taken at its submission."""
        marks = self._timeline.pop(id(req), None)
        if marks is None:              # put in the pool past submit()
            return
        aid, t_submit, t_prefill, t_first = marks
        now = time.perf_counter()
        tr = self.tracer
        tr.async_event("request", "b", aid, ts=t_submit, cat="request",
                       rid=req.rid)
        tr.async_span("queued", aid, t_submit, t_prefill, cat="request",
                      wait_ms=(t_prefill - t_submit) * 1e3)
        tr.async_span("prefill", aid, t_prefill, t_first, cat="request",
                      tokens=len(req.prompt))
        tr.async_span("decode", aid, t_first, now, cat="request",
                      tokens=len(req.tokens))
        tr.async_event("request", "e", aid, ts=now, cat="request")

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
