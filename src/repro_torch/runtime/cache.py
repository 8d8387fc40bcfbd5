"""Compile cache keyed by canonical graph signatures.

Copy of :mod:`repro.runtime.cache`.  Tracing, partitioning and
lowering a dataflow graph is the expensive part of ``compile_graph``
(and a ``cuda_stream`` app's kernels are built from source at its first
launch); a serving engine that re-traced per request would spend its
life in the compiler.  The :class:`CompileCache` memoizes
:func:`repro_torch.core.compiler.compile_graph` on
``(DataflowGraph.signature(), backend, options)`` — a *structural*
key, so a topologically identical graph built elsewhere (renamed
channels included) still hits.

Canonicalization caveat: the pass pipeline rewrites graphs in place,
so a graph's signature can legitimately change once across its first
compile (e.g. auto-split inserts a stage).  The cache therefore
registers the *post-canonicalization* signature as an alias of the
same entry — resubmitting either form hits.  The pipeline is
idempotent, so there are at most two keys per app.

Compile options are part of the key (the engine's ``device=`` and
``tune=`` among them).  Option values that carry a ``to_json`` method
are keyed by their JSON form, so two equal configs built by different
processes still map to one entry.  A ``calibrate=`` option is resolved
here, into the backend it names
(:func:`repro_torch.backends.resolve_calibrated`): the entry is keyed by
that backend's ``cache_key()``, which covers the fitted spec, so
calibrated apps never mix with uncalibrated ones, and a refit (by the
drift sentinel) compiles anew.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable

from repro_torch.backends import resolve, resolve_calibrated
from repro_torch.core.compiler import compile_graph
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.host import CompiledApp

__all__ = ["CacheStats", "CompileCache"]


def _opt_repr(v: Any) -> str:
    """Stable string form of a compile option for cache keying.

    Values exposing ``to_json`` (tuning configs, specs grown later)
    are keyed structurally so equal-by-value instances from different
    builders share an entry; everything else falls back to ``repr``.
    """
    to_json = getattr(v, "to_json", None)
    if callable(to_json):
        try:
            import json
            return v.__class__.__name__ + json.dumps(to_json(),
                                                     sort_keys=True)
        except (TypeError, ValueError):
            pass
    return repr(v)


@dataclasses.dataclass
class CacheStats:
    """Compile-cache counters, accounted **per compile event**.

    ``hits``/``misses`` count *unique resolutions*: the first time a
    given graph object (per backend/options) is resolved against the
    structural table, it either reuses an existing compile (hit) or
    triggers one (miss).  Re-submitting the same object — every
    request of a serving stream — is a ``requests`` tick only, so a
    batched engine serving one app N times reports 1 miss and N
    requests, not N-1 phantom hits: ``hit_rate`` measures how often
    the cache avoided a compile, not how often it was asked.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    requests: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "requests": self.requests,
                "hit_rate": self.hit_rate}


class _PendingCompile:
    """Future for an in-flight trace: same-key callers wait, not re-trace."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._app: CompiledApp | None = None
        self._err: BaseException | None = None

    def resolve(self, app: CompiledApp) -> None:
        self._app = app
        self._done.set()

    def fail(self, err: BaseException) -> None:
        self._err = err
        self._done.set()

    def wait(self) -> CompiledApp:
        self._done.wait()
        if self._err is not None:
            raise self._err
        assert self._app is not None
        return self._app


class CompileCache:
    """LRU cache of :class:`CompiledApp` keyed by graph signature.

    Thread-safe: the serving engine compiles on submitter threads.
    Tracing happens OUTSIDE the table lock — a miss installs a
    per-key :class:`_PendingCompile`, so concurrent submits of the
    same graph trace exactly once (one miss; waiters that are
    *distinct* graph objects count as hits, repeats of the same
    object count as ``requests`` — see :class:`CacheStats`) while
    hits for other, already-compiled apps proceed unstalled.
    """

    def __init__(self, maxsize: int = 64,
                 compile_fn: Callable[..., CompiledApp] = compile_graph):
        self.maxsize = maxsize
        self.stats = CacheStats()
        self._compile = compile_fn
        self._entries: OrderedDict[tuple, CompiledApp] = OrderedDict()
        self._pending: dict[tuple, _PendingCompile] = {}
        # identity fast path: a graph OBJECT already served maps straight
        # to its app without re-hashing the structure on every request
        # (assumes graphs are not mutated once submitted for serving)
        self._by_graph: weakref.WeakKeyDictionary[DataflowGraph, dict] = \
            weakref.WeakKeyDictionary()
        # per-object locks: canonicalization passes rewrite a graph IN
        # PLACE during its first compile, so a concurrent get() on the
        # same object must not read its structure mid-rewrite
        self._graph_locks: weakref.WeakKeyDictionary[DataflowGraph, Any] = \
            weakref.WeakKeyDictionary()
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(sig: str, backend_key: str, opts: dict[str, Any]) -> tuple:
        return (sig, backend_key, tuple(sorted((k, _opt_repr(v))
                                               for k, v in opts.items())))

    def get(self, graph: DataflowGraph, backend="cuda_stream",
            **compile_kwargs: Any) -> CompiledApp:
        """Return a compiled app for ``graph``, tracing at most once.

        ``backend`` is a registered name or a
        :class:`~repro_torch.backends.Backend`; the entry is keyed by the
        resolved record's :meth:`~repro_torch.backends.Backend.cache_key`
        (its name, plus a digest of the constants for a calibrated
        copy), so calibrated and uncalibrated compiles never share an
        entry.
        """
        calibrate = compile_kwargs.pop("calibrate", None)
        if calibrate is None or calibrate is False:
            backend = resolve(backend)
        else:
            from repro_torch.tune.store import detect_device_kind
            backend = resolve_calibrated(
                backend, calibrate,
                device_kind=detect_device_kind(compile_kwargs.get("device")))
        # ``trace`` is observability plumbing, not a compile option: a
        # Tracer's repr is identity-based, so keying it would split the
        # cache per tracer instance for semantically identical compiles
        trace = compile_kwargs.pop("trace", None)
        okey = (backend.cache_key(), tuple(sorted((k, _opt_repr(v))
                                           for k, v in compile_kwargs.items())))
        with self._lock:
            self.stats.requests += 1
            per = self._by_graph.get(graph)
            if per is not None and okey in per:
                # repeat of an already-resolved object: a served
                # request, not a fresh cache consultation (hit/miss
                # are per compile event — see CacheStats)
                return per[okey]
            glock = self._graph_locks.get(graph)
            if glock is None:
                glock = self._graph_locks[graph] = threading.Lock()
        with glock:
            return self._get_slow(graph, okey, backend, compile_kwargs,
                                  trace=trace)

    def _get_slow(self, graph: DataflowGraph, okey: tuple, backend,
                  compile_kwargs: dict[str, Any],
                  trace: Any = None) -> CompiledApp:
        """Signature lookup / trace under the per-graph-object lock."""
        with self._lock:
            per = self._by_graph.get(graph)
            if per is not None and okey in per:   # a peer just filled it
                return per[okey]     # same object: same compile event
            key = self._key(graph.signature(), backend.cache_key(),
                            compile_kwargs)
            app = self._entries.get(key)
            if app is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                self._by_graph.setdefault(graph, {})[okey] = app
                return app
            pending = self._pending.get(key)
            if pending is None:
                self._pending[key] = pending = _PendingCompile()
                self.stats.misses += 1
                owner = True
            else:
                self.stats.hits += 1        # someone else is tracing it
                owner = False
        if not owner:
            app = pending.wait()
            with self._lock:
                self._by_graph.setdefault(graph, {})[okey] = app
            return app
        try:
            # only forward trace= when set: custom compile_fns need not
            # grow the parameter to keep working untraced
            if trace is not None:
                compile_kwargs = dict(compile_kwargs, trace=trace)
            app = self._compile(graph, backend=backend, **compile_kwargs)
        except BaseException as e:
            with self._lock:
                del self._pending[key]
            pending.fail(e)
            raise
        with self._lock:
            self._entries[key] = app
            # alias: the canonicalized graph's signature (module doc)
            canon = self._key(app.graph.signature(), backend.cache_key(),
                              compile_kwargs)
            self._entries.setdefault(canon, app)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            self._by_graph.setdefault(graph, {})[okey] = app
            del self._pending[key]
        pending.resolve(app)
        return app

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_graph.clear()
