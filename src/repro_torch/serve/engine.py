"""Concurrent fact-serving tier: snapshot-isolated reads over a mutating
engine (the paper's third pillar — derivation trees enabling parallel
read/write access — served over the repo's MVCC machinery).

``FactServer`` wraps one ``HiperfactEngine`` (or its sharded variant)
and gives three things the bare engine does not:

* **Snapshot-isolated reads.**  Every served result is pinned to the
  store's existing ``(version, data_version)`` token vector.  Writers
  (``append``/``delete`` + re-infer) run under the server's write lock
  inside a seqlock epoch (odd while a write is in flight); the read
  fast paths — result-cache hits and batched rank-1 probes — take *no
  lock*: they capture the epoch, capture the token, do their work, and
  re-validate the epoch, retrying on movement.  A read that must enter
  evaluation serializes with writers on the same lock (evaluation
  mutates query-node state, and in demand mode the store itself), so no
  result can ever mix rows from two frontier states.
* **Delta-aware requery.**  The server opts its engine into
  ``enable_delta_requery``: tracked queries keep signed per-row
  derivation counts (``core.querycache.DeltaQueryNode``) and a repeat
  query at a moved watermark folds only the ±frontier windows (the
  signed inclusion–exclusion of the delta fixpoint) into the existing
  result instead of re-evaluating the full join — steady-state requery
  runs zero full evaluations.
* **Cross-request batching.**  Concurrent single-condition point
  queries on the same ``(fact type, anchor component)`` rank-1 index
  coalesce — after a small admission window, with per-tenant
  round-robin fairness — into one ``FactStore.lookup_many`` /
  ``Ops.batch_probe`` device call per store (one ``probe_sorted``
  launch on an AI index under the ``torch`` backend), amortizing the
  bulk probe across tenants.

With ``record_history=True`` every write appends ``(kind, facts,
token)`` to ``server.history`` (and evaluation-path reads that moved
the token — demand materialization — append ``("materialize", ...)``
entries), so a test can replay the exact write prefix behind any served
token on a single-threaded oracle engine and demand bit-identical
results (``tests/test_serving.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from repro_torch.core.conditions import Condition, is_var
from repro_torch.core.facts import ValueType, decode_value
from repro_torch.core.store import Component

_VIEW_PREFIX = "__shard_view:"


@dataclasses.dataclass
class ServedResult:
    """One served read: decoded rows + the snapshot token they are
    pinned to.  ``mode`` records which path served it: ``cache`` (lock-
    free result-cache hit), ``delta`` (signed-window fold), ``full``
    (tracked full evaluation), or ``batched`` (coalesced rank-1
    probe)."""

    rows: list
    token: tuple
    mode: str
    tenant: str = "default"

    def checksum(self) -> int:
        import zlib
        return zlib.crc32("\n".join(
            sorted(repr(sorted(r.items())) for r in self.rows)).encode())


class _BatchReq:
    __slots__ = ("cond", "tenant", "consts", "result", "error", "done")

    def __init__(self, cond: Condition, tenant: str, consts: dict):
        self.cond = cond
        self.tenant = tenant
        self.consts = consts  # encoded constant slots (comp -> lane)
        self.result: ServedResult | None = None
        self.error: Exception | None = None
        self.done = threading.Event()


class _ProbeBatcher:
    """Admission-window coalescer for single-condition point queries.

    Requests bucket by ``(fact_type, anchor component)``; a flush takes
    up to ``max_batch`` requests per bucket in per-tenant round-robin
    order (no tenant can starve another inside a bucket) and resolves
    the whole wave with one ``lookup_many`` per store.  ``window`` is
    the admission delay in seconds after the first arrival; ``None``
    runs no background thread — callers must ``flush()`` explicitly
    (the deterministic mode the batching tests and bench use).
    """

    def __init__(self, server: "FactServer", window: "float | None",
                 max_batch: int):
        self.server = server
        self.window = window
        self.max_batch = max_batch
        self._cv = threading.Condition()
        self._buckets: dict[tuple, dict[str, deque]] = {}
        self._pending = 0
        self._stop = False
        self._thread: threading.Thread | None = None
        # observability: device calls issued, queries answered through
        # them, and the per-flush coalesce ratio (queries / device call)
        self.device_calls = 0
        self.batched_queries = 0
        self.flush_sizes: list[int] = []
        self.coalesce: list[float] = []
        self.torn_retries = 0  # lock-free attempts that raised mid-write

    # -------------------------------------------------------------- intake
    def _bucket_of(self, c: Condition, consts: dict) -> tuple:
        for comp in (Component.ID, Component.ATTR, Component.VAL):
            if comp in consts:
                return (c.fact_type, int(comp))
        raise ValueError("unanchored condition reached the batcher")

    def submit(self, c: Condition, tenant: str) -> ServedResult:
        with self.server._lock:  # interning-safe const encoding
            consts = dict(c.const_slots(self.server.engine.store.strings))
        req = _BatchReq(c, tenant, consts)
        bucket = self._bucket_of(c, consts)
        with self._cv:
            (self._buckets.setdefault(bucket, {})
                 .setdefault(tenant, deque()).append(req))
            self._pending += 1
            if self._thread is None and self.window is not None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()
            self._cv.notify_all()
        if not req.done.wait(timeout=120.0):
            raise TimeoutError("batched probe was never flushed "
                               "(manual-flush batcher without a flush()?)")
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending == 0 and not self._stop:
                    self._cv.wait(0.05)
                if self._stop and self._pending == 0:
                    return
            if self.window:
                time.sleep(self.window)  # admission window
            self.flush()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    # --------------------------------------------------------------- flush
    def _take_wave(self) -> dict[tuple, list]:
        """Per bucket: up to ``max_batch`` requests, one per tenant per
        round-robin turn (deterministic tenant order)."""
        with self._cv:
            out: dict[tuple, list] = {}
            for bucket, tenants in self._buckets.items():
                taken: list[_BatchReq] = []
                order = sorted(tenants)
                while len(taken) < self.max_batch:
                    progressed = False
                    for t in order:
                        dq = tenants.get(t)
                        if dq:
                            taken.append(dq.popleft())
                            progressed = True
                            if len(taken) >= self.max_batch:
                                break
                    if not progressed:
                        break
                if taken:
                    out[bucket] = taken
                    self._pending -= len(taken)
            return out

    def flush(self) -> int:
        """Drain every queued request (possibly several waves per
        bucket when a queue exceeds ``max_batch``).  Returns the number
        of requests resolved."""
        n = 0
        while True:
            wave = self._take_wave()
            if not wave:
                return n
            for bucket, reqs in wave.items():
                self._run_bucket(bucket, reqs)
                n += len(reqs)

    def queued(self) -> int:
        with self._cv:
            return self._pending

    def _run_bucket(self, bucket: tuple, reqs: list) -> None:
        try:
            per_req_rows, token, calls = self._probe(bucket, reqs)
        except Exception as exc:  # pragma: no cover - defensive
            for r in reqs:
                r.error = exc
                r.done.set()
            return
        self.device_calls += calls
        self.batched_queries += len(reqs)
        self.flush_sizes.append(len(reqs))
        self.coalesce.append(len(reqs) / max(1, calls))
        for req, rows in zip(reqs, per_req_rows):
            req.result = ServedResult(rows, token, "batched", req.tenant)
            req.done.set()

    def _probe(self, bucket: tuple, reqs: list):
        """Resolve one bucket's wave at a consistent frontier: seqlock
        fast path (epoch capture → probe+decode → epoch re-check, retry
        on movement), falling back to the write lock if writers keep
        winning the race.  A lock-free attempt that raises an
        ``IndexError`` or ``ValueError`` while the epoch moved read a
        half-swapped index (``SortedArrayIndex`` assigns the sorted
        mirror and its permutation one after the other, so a new mirror
        can meet an old, shorter permutation) and is retried like any
        other torn attempt; one that raises at a stable epoch, or
        raises anything else, is a real error and propagates."""
        server = self.server
        for _ in range(50):
            e0 = server._epoch
            if e0 & 1:
                time.sleep(0.0002)
                continue
            try:
                out = self._probe_once(bucket, reqs)
            except (IndexError, ValueError):
                if server._epoch == e0:
                    raise
                self.torn_retries += 1
                continue
            if server._epoch == e0:
                return out
        with server._lock:
            return self._probe_once(bucket, reqs)

    def _probe_once(self, bucket: tuple, reqs: list):
        server = self.server
        ftype, comp_i = bucket
        comp = Component(comp_i)
        token = server.snapshot_token()
        anchor = [req.consts[comp] for req in reqs]
        uniq = sorted(set(anchor))
        vpos = {v: i for i, v in enumerate(uniq)}
        values = np.asarray(uniq, np.int64)
        calls = 0
        # per store: CSR windows per probe value, residual const filter
        # and variable decode applied per request
        per_req_rows: list[list[dict]] = [[] for _ in reqs]
        per_req_seen: list[set] = [set() for _ in reqs]
        for store in server._stores():
            t = store.tables.get(ftype)
            if t is None:
                continue
            rows, offsets = store.lookup_many(ftype, comp, values)
            calls += 1
            if len(rows) == 0:
                continue
            strings = store.strings
            for ri, req in enumerate(reqs):
                i = vpos[anchor[ri]]
                r = rows[offsets[i]:offsets[i + 1]]
                if len(r) == 0:
                    continue
                for c2, v2 in req.consts.items():
                    if c2 == comp:
                        continue
                    r = r[t.column(c2)[r] == v2]
                    if len(r) == 0:
                        break
                if len(r) == 0:
                    continue
                vslots = req.cond.var_slots()
                cols = {name: t.column(c2)[r] for name, c2 in vslots}
                seen = per_req_seen[ri]
                for j in range(len(r)):
                    key = tuple(int(cols[name][j]) for name, _ in vslots)
                    if key in seen:
                        continue
                    seen.add(key)
                    row = {}
                    for name, c2 in vslots:
                        lane = int(cols[name][j])
                        if c2 == Component.VAL and \
                                req.cond.valtype != ValueType.STRING:
                            row[name] = decode_value(lane, req.cond.valtype,
                                                     strings)
                        else:
                            row[name] = strings.lookup_id(lane)
                    per_req_rows[ri].append(row)
        return per_req_rows, token, calls

    def stats(self) -> dict:
        cz = sorted(self.coalesce)
        p50 = cz[len(cz) // 2] if cz else 0.0
        return {"device_calls": self.device_calls,
                "batched_queries": self.batched_queries,
                "flushes": len(self.flush_sizes),
                "coalesce_p50": p50,
                "coalesce_mean": (sum(cz) / len(cz)) if cz else 0.0,
                "torn_retries": self.torn_retries}


class FactServer:
    """Multi-tenant serving frontend over one (possibly sharded)
    ``HiperfactEngine`` — see the module docstring for the isolation
    protocol.  Thread-safe: any number of reader threads may call
    ``serve``/``query`` while writer threads call ``append``/``delete``.

    ``batch_window``: admission window (seconds) for the probe
    batcher; ``None`` disables the background flusher (tests call
    ``flush_batches()`` explicitly); ``batching=False`` disables
    coalescing entirely (every read takes the evaluation path).
    """

    def __init__(self, engine, batch_window: "float | None" = 0.002,
                 max_batch: int = 64, batching: bool = True,
                 record_history: bool = False):
        self.engine = engine
        engine.enable_delta_requery(True)
        self._lock = threading.RLock()
        self._epoch = 0          # seqlock: odd while a write is in flight
        self._types: tuple = ()  # every non-view table the server has seen
        self.record_history = record_history
        self.history: list[tuple] = []
        # evaluation-path reads mutate the store only in demand mode
        # (cone materialization); only then must they bump the epoch so
        # lock-free readers cannot capture a mid-materialization token
        self._eval_mutates = engine.config.eval_mode == "demand"
        self._served: dict[str, int] = {"cache": 0, "delta": 0, "full": 0,
                                        "batched": 0}
        self._writes = 0
        self._retries = 0
        self._count_lock = threading.Lock()
        self._batcher = (_ProbeBatcher(self, batch_window, max_batch)
                         if batching else None)
        with self._lock:
            self._refresh_types()
            if record_history:
                self.history.append(("init", None, self.snapshot_token()))

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()

    def __enter__(self) -> "FactServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ snapshots
    def _stores(self) -> list:
        eng = self.engine
        if hasattr(eng, "workers"):  # a ShardedEngine: one store per shard
            return [w.store for w in eng.workers]
        return [eng.store]

    def _refresh_types(self) -> None:
        names = {n for s in self._stores() for n in s.tables
                 if not n.startswith(_VIEW_PREFIX)}
        self._types = tuple(sorted(set(self._types) | names))

    def snapshot_token(self) -> tuple:
        """The engine's ``(type, version, data_version)`` vector over
        every table the server has seen — per shard on a sharded
        engine.  This is the MVCC identity a ``ServedResult`` is pinned
        to; with ``record_history`` each write logs its post-state
        token, so a result's token names the exact write prefix it saw."""
        return self.engine._query_version_token(self._types)

    # --------------------------------------------------------------- writes
    def append(self, facts: list, infer: "bool | None" = None) -> int:
        """Insert facts and (by default) re-infer to fixpoint.  Demand
        engines default to ``infer=False`` — queries materialize their
        own cones, that is the point of the mode."""
        return self._write("append", list(facts), infer)

    def delete(self, facts: list, infer: "bool | None" = None) -> int:
        return self._write("delete", list(facts), infer)

    def _write(self, kind: str, facts: list, infer: "bool | None") -> int:
        eng = self.engine
        if infer is None:
            infer = eng.config.eval_mode != "demand"
        with self._lock:
            self._epoch += 1
            try:
                n = (eng.insert_facts(facts) if kind == "append"
                     else eng.delete_facts(facts))
                if infer:
                    eng.infer()
            finally:
                self._refresh_types()
                self._epoch += 1
            self._writes += 1
            if self.record_history:
                self.history.append((kind, facts, self.snapshot_token()))
        return n

    def _paused_write(self):
        """Test hook: a write held open mid-flight (epoch odd, lock
        held).  Readers must block or retry — never observe the torn
        state.  Use as a context manager; mutate ``server.engine``
        inside the block."""
        server = self

        class _Paused:
            def __enter__(self):
                server._lock.acquire()
                server._epoch += 1
                return server.engine

            def __exit__(self, *exc):
                server._refresh_types()
                server._epoch += 1
                if server.record_history:
                    server.history.append(
                        ("append", None, server.snapshot_token()))
                server._lock.release()

        return _Paused()

    # ---------------------------------------------------------------- reads
    def serve(self, conditions: list, tenant: str = "default"
              ) -> ServedResult:
        """Serve one read at a consistent snapshot.  Single-condition
        point queries route through the probe batcher; everything else
        (and every demand-mode query against undischarged rules) takes
        the evaluation path."""
        conditions = list(conditions)
        if self._batcher is not None and self._batch_eligible(conditions):
            res = self._batcher.submit(conditions[0], tenant)
            self._count("batched")
            return res
        return self._serve_eval(conditions, tenant)

    def query(self, conditions: list, tenant: str = "default") -> list:
        """Convenience: just the rows."""
        return self.serve(conditions, tenant).rows

    def flush_batches(self) -> int:
        """Manually drain the probe batcher (deterministic test mode)."""
        return self._batcher.flush() if self._batcher is not None else 0

    def _batch_eligible(self, conditions: list) -> bool:
        if len(conditions) != 1:
            return False
        c = conditions[0]
        if not isinstance(c, Condition) or c.tests:
            return False
        eng = self.engine
        if eng.config.eval_mode == "demand" and eng.rules:
            return False  # the cone must materialize: evaluation path
        slots = list(c.slots().values())
        nvars = sum(1 for t in slots if is_var(t))
        # need an anchor constant, at least one variable, and no
        # repeated variable (an equality constraint the probe can't see)
        return 0 < nvars < 3 and nvars == len(c.variables())

    def _serve_eval(self, conditions: list, tenant: str) -> ServedResult:
        eng = self.engine
        qtypes = sorted({c.fact_type for c in conditions})
        # lock-free fast path: result-cache hit at a stable epoch.
        # Demand engines must not take it: their cache key covers only
        # the query's own types, and a cold append moves just the base
        # tables — materialization has to run before the key is valid.
        cache = None if self._eval_mutates else eng._result_cache
        if cache is not None:
            for _ in range(50):
                e0 = self._epoch
                if e0 & 1:
                    self._retries += 1
                    time.sleep(0.0002)
                    continue
                token = self.snapshot_token()
                key = cache.key(conditions, eng._query_version_token(qtypes))
                hit = cache.lookup(key) if key is not None else None
                if self._epoch != e0:
                    self._retries += 1
                    continue
                if hit is not None:
                    self._count("cache")
                    return ServedResult([dict(r) for r in hit], token,
                                        "cache", tenant)
                break
        # evaluation path: serialized with writers (evaluation mutates
        # query-node state; in demand mode, the store itself)
        with self._lock:
            if self._eval_mutates:
                self._epoch += 1
            try:
                before = eng.requery_stats()
                rows = eng.query(conditions)
                after = eng.requery_stats()
                token = self.snapshot_token()
            finally:
                if self._eval_mutates:
                    self._refresh_types()
                    self._epoch += 1
            if self.record_history and (
                    not self.history or self.history[-1][2] != token):
                # demand materialization moved the token without a
                # write op: log it so every served token stays mapped
                # to a replayable prefix
                self.history.append(("materialize", None, token))
        if after["full_evals"] > before["full_evals"]:
            mode = "full"
        elif after["delta_folds"] > before["delta_folds"]:
            mode = "delta"
        else:
            mode = "cache"
        self._count(mode)
        return ServedResult(rows, token, mode, tenant)

    # ---------------------------------------------------------------- stats
    def _count(self, mode: str) -> None:
        with self._count_lock:
            self._served[mode] = self._served.get(mode, 0) + 1

    def stats(self) -> dict:
        out = {"served": dict(self._served), "writes": self._writes,
               "epoch_retries": self._retries,
               "requery": self.engine.requery_stats()}
        if self._batcher is not None:
            out["batch"] = self._batcher.stats()
        return out


def project_token(token: tuple, types) -> tuple:
    """Restrict a snapshot token to the entries of the given fact
    types (the shape ``engine._query_version_token(types)`` would
    return for types the token covers)."""
    ts = set(types)
    return tuple(e for e in token if e[0] in ts)
