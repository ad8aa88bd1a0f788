"""The port's invariant analyzer (docs/static-analysis.md), a copy of
the JAX package's ``analysis/`` repointed at ``pilosa_tpu_torch/``.

Two halves:

* ``astlint`` — a scope-aware AST lint suite encoding the invariants
  review used to enforce (wall-clock timing, exception swallows,
  batcher and router bypass, cross-thread context discipline, tenant
  attribution, the metrics / events / alerts / failpoint catalogs).
  Run as ``python -m pilosa_tpu_torch.analysis`` from the repo root, or
  ``python -m pilosa_tpu_torch analyze``; exits non-zero on any finding.

* ``lockcheck`` — a runtime lock-order race detector: instrumented
  Lock/RLock/Condition (adopted tree-wide via utils/locks.py) that
  records per-thread held-lock stacks, builds the global acquisition-
  order graph over named lock classes, and reports order-inversion
  cycles and undeclared same-class nesting at process exit and at
  /debug/locks.  Armed with ``PILOSA_TPU_LOCKCHECK=1`` (``=strict``
  additionally fails the process on violations).

Deviations from the JAX package's analyzer:

* No ``traced-closure`` rule.  It guards a jax hazard: a cached
  executable that re-traces re-reads closure cells a later loop
  iteration rebound.  The port's eager PyTorch reducers run their
  Python body on every call, and a captured CUDA graph bakes in
  tensors, not closure cells, so the hazard does not exist here.
* No ``tier1-legs`` rule.  The JAX package's analyzer already checks
  that every ``tests/test_*.py`` — the port's tests included — sits in
  a leg of ``scripts/tier1_split.sh``; a second copy would only repeat
  its findings.
* ``metrics-docs``, ``event-names`` and ``alert-names`` read
  ``docs/observability.md`` and the port's supplement
  ``analysis/catalog.md`` (the series, events and alerts only the port
  has), and hold the port's call sites to both, two ways.
* ``batcher-bypass`` looks for the stacked executor's reducers
  (``parallel/stacked.py``) called outside ``parallel/``.

This package deliberately imports nothing heavyweight at package level:
``utils/locks.py`` pulls ``lockcheck`` on every armed process start, and
the lint suite runs without torch.
"""
