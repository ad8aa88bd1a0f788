"""AOT warmup replayer + warm-start coordinator (docs/warmup.md
"Warmup lifecycle").

The coordinator owns the whole warm-start surface for one Server:

* at boot (after local WAL replay has made the holder queryable, and
  concurrent with the rest of startup — cluster join, serve loop) it
  loads the signature corpus, seeds the traffic recorder with it, and
  — when there is anything worth warming — replays the top-N corpus
  queries through the REAL executor paths before the node reports
  READY.  Replay through ``Executor.execute`` is deliberate: it drives
  the same WholeQueryRunner/MeshExecutor compile paths production
  traffic does (hitting the persistent compile cache at disk speed),
  and rebuilds the prepared-statement cache entries as a side effect,
  so a prepared hit survives a deploy.
* while serving it flushes the recorder to the corpus on a fixed
  cadence (its own monitor thread), so a kill -9 loses at most a few
  seconds of hit-count drift.
* every failure degrades: a corrupt/empty/stale corpus means fewer (or
  zero) replays, a replay error (index dropped since the corpus was
  written) is counted and skipped, the budget expiring abandons the
  remaining entries — warmup can make READY *later*, never *absent*.

Status (phase, progress, compile-seconds-saved) feeds /status,
/debug/vars, the event journal (``warmup.start``/``warmup.done``) and
the ``warmup.*`` gauges.

Port copy of the JAX package's ``warmup/replayer.py``.  Deviations:

* Each corpus entry is replayed twice (``REPLAYS``).  The port runs a
  whole-query signature eagerly on its first sighting and captures its
  CUDA graph on its second (parallel/wholequery.py), so the second
  replay is the capture and the first client request after READY
  replays the graph.  ``replayed`` counts executions: a clean warm-up
  of N entries replays 2N.  The replay bypasses the result cache
  (cache/results.py ``bypassed``), so both runs reach the device.
* CUDA graphs do not outlive their process and there is no persistent
  compile cache (warmup/__init__.py), so a warm replay pays every
  capture again: ``compileS`` is the capture seconds the replay paid,
  and ``savedCompileS`` (the corpus's recorded capture seconds minus
  those) stays near 0.  What the warm start saves is the capture on a
  client's second request, moved before READY.
* A replay error is counted and the node goes READY anyway, as in the
  JAX package; callers that must not hide a failed capture check
  ``errors`` and ``skipped``.
"""

from __future__ import annotations

import threading
import time
from time import perf_counter

from ..cache.results import bypassed
from ..utils import events
from ..utils.devobs import COMPILES
from ..utils.locks import make_lock
from .corpus import CorpusRecorder, SignatureCorpus, top_n

PHASE_COLD = "cold"        # no corpus / warmup disabled: straight to READY
PHASE_WARMING = "warming"  # replaying — /status not READY yet
PHASE_READY = "ready"


def _wall_stamp() -> float: return time.time()  # display-only wall clock


class WarmupCoordinator:
    """One per Server: corpus + recorder + the warmup/flush thread."""

    FLUSH_INTERVAL_S = 5.0
    # executions per corpus entry: the eager first sighting, then the
    # capture (module docstring)
    REPLAYS = 2

    def __init__(self, executor, path: str, top_n: int = 32,
                 budget_s: float = 30.0, logger=None, stats=None):
        self.executor = executor
        self.path = path
        self.top_n = max(int(top_n), 0)
        self.budget_s = float(budget_s)
        self.logger = logger
        self.stats = stats
        self.corpus = SignatureCorpus(path)
        # the compaction survivor set keeps a margin beyond the replay
        # set so ranking churn near the cut line doesn't lose history
        self.recorder = CorpusRecorder(keep_n=max(self.top_n, 16) * 4)
        self._lock = make_lock("warmup")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.on_ready = None  # Server hook: flip node state to READY
        # status surface (all read under _lock via status())
        self.phase = PHASE_COLD
        self.corpus_entries = 0
        self.planned = 0
        self.replayed = 0
        self.errors = 0
        self.skipped = 0
        self.saved_compile_s = 0.0
        self.warm_compile_s = 0.0
        self.retraces_during_warm = 0
        self.elapsed_s = 0.0
        self.cache_enabled = False
        self._pending: list[dict] = []

    # -- boot --------------------------------------------------------------

    def open(self) -> bool:
        """Load the corpus (torn tail truncated, bad records dropped),
        seed the recorder, pick the replay set.  Returns True when the
        node should enter the warming phase.  Never raises."""
        self.corpus.open()
        folded = SignatureCorpus.load(self.path)
        self.recorder.seed(folded)
        pending = top_n(list(folded.values()),
                        self.top_n) if self.top_n > 0 else []
        with self._lock:
            self.corpus_entries = len(folded)
            self._pending = pending
            self.planned = len(pending)
            self.phase = PHASE_WARMING if pending else PHASE_READY
            return self.phase == PHASE_WARMING

    def start(self):
        """Spawn the warmup+flush thread (daemon: telemetry-grade)."""
        self._thread = threading.Thread(target=self._run, name="warmup",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        try:
            warming = False
            with self._lock:
                warming = self.phase == PHASE_WARMING
            if warming:
                self._warm()
        finally:
            with self._lock:
                self.phase = PHASE_READY
            cb = self.on_ready
            if cb is not None:
                try:
                    cb()
                # lint: allow(swallowed-exception) — the READY callback
                # flips cluster state; a failure there leaves the node
                # warming-visible but the flush loop (and serving) alive
                except Exception:
                    pass
        while not self._stop.wait(self.FLUSH_INTERVAL_S):
            self.recorder.flush(self.corpus)

    # -- the replay itself -------------------------------------------------

    def _warm(self):
        with self._lock:
            pending = list(self._pending)
        t0 = perf_counter()
        c0 = COMPILES.totals()
        events.emit("warmup.start", entries=self.corpus_entries,
                    topN=len(pending), budgetS=round(self.budget_s, 1))
        expected_s = 0.0
        for done, rec in enumerate(pending):
            if self._stop.is_set() or \
                    perf_counter() - t0 >= self.budget_s:
                with self._lock:
                    self.skipped = len(pending) - done
                break
            try:
                with bypassed():
                    for _ in range(self.REPLAYS):
                        self.executor.execute(rec["index"], rec["query"])
                        with self._lock:
                            self.replayed += 1
                expected_s += float(rec.get("compileS", 0.0))
            except Exception as e:
                # a stale corpus entry (index dropped, field renamed)
                # must not fail READY: count it, tell the log, move on
                with self._lock:
                    self.errors += 1
                log = self.logger
                if log is not None:
                    try:
                        log.event("warmup.replay_error",
                                  index=rec.get("index", ""),
                                  template=rec.get("template", ""),
                                  error=str(e))
                    # lint: allow(swallowed-exception) — a closed log
                    # stream costs a line; the error is already counted
                    except Exception:
                        pass
        c1 = COMPILES.totals()
        warm_s = max(c1["compileSecondsTotal"]
                     - c0["compileSecondsTotal"], 0.0)
        with self._lock:
            self.elapsed_s = round(perf_counter() - t0, 3)
            self.warm_compile_s = round(warm_s, 4)
            # what the corpus said these programs cost to compile cold,
            # minus what the warm replay actually paid (persistent-cache
            # hits compile at disk speed) — the headline number
            self.saved_compile_s = round(max(expected_s - warm_s, 0.0), 4)
            self.retraces_during_warm = c1["retraces"] - c0["retraces"]
            replayed, errors, skipped = (self.replayed, self.errors,
                                         self.skipped)
            elapsed, saved = self.elapsed_s, self.saved_compile_s
        stats = self.stats
        if stats is not None:
            stats.gauge("warmup.replayed", replayed)
            stats.gauge("warmup.errors", errors)
            stats.gauge("warmup.saved_seconds", saved)
        events.emit("warmup.done", replayed=replayed, errors=errors,
                    skipped=skipped, elapsedS=elapsed, savedS=saved,
                    compileS=round(warm_s, 4),
                    retraces=self.retraces_during_warm)

    # -- serving-time surfaces ---------------------------------------------

    def note_query(self, index: str, qtext: str):
        self.recorder.note(index, qtext)

    def warming(self) -> bool:
        with self._lock:
            return self.phase == PHASE_WARMING

    def status(self) -> dict:
        with self._lock:
            return {"phase": self.phase,
                    "corpusEntries": self.corpus_entries,
                    "topN": self.top_n,
                    "budgetS": self.budget_s,
                    "planned": self.planned,
                    "replayed": self.replayed,
                    "errors": self.errors,
                    "skipped": self.skipped,
                    "elapsedS": self.elapsed_s,
                    "compileS": self.warm_compile_s,
                    "savedCompileS": self.saved_compile_s,
                    "retracesDuringWarm": self.retraces_during_warm,
                    "cacheEnabled": self.cache_enabled,
                    "recorder": self.recorder.snapshot(),
                    "corpusWriteErrors": self.corpus.write_errors}

    # -- shutdown ----------------------------------------------------------

    def close(self):
        """Stop the thread, take a final flush so the corpus reflects
        the full run (clean shutdowns lose nothing; kill -9 loses at
        most FLUSH_INTERVAL_S of drift)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self.recorder.flush(self.corpus)
        self.corpus.close()
