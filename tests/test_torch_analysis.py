"""The port's invariant analyzer (pilosa_tpu_torch/analysis) against the
JAX package's (pilosa_tpu/analysis): the cases of tests/test_analysis.py
that apply to the port — every case but the ``traced-closure`` ones,
whose jax re-trace hazard the port does not have.

Each seeded source goes through both analyzers' ``lint_source`` and the
findings (rule, line, message) must be the same.  Then the port's own
cases: the retargeted batcher-bypass (stacked-executor reducers) and
router-bypass (``pilosa_tpu_torch/parallel/``) rules, the metrics /
events / alerts catalogs two ways against ``docs/observability.md`` and
the port's supplement, the failpoint catalog, the lock-order detector
through ``pilosa_tpu_torch.utils.locks`` (strict mode fails the process
on a seeded inversion, observe mode exits 0), ``GET /debug/locks`` on a
port server unarmed and armed, and the whole-tree gate: the port's
analyzer exits clean on this checkout.  Seeded violations live inside
strings, so neither analyzer flags this file.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from pilosa_tpu.analysis import astlint as jax_astlint
from pilosa_tpu_torch import cli as port_cli
from pilosa_tpu_torch.analysis import astlint, lockcheck
from pilosa_tpu_torch.analysis.astlint import (
    Suppressions,
    lint_source,
    run as run_analysis,
)

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT_REL = "pilosa_tpu_torch/executor/snippet.py"
JAX_REL = "pilosa_tpu/executor/snippet.py"


def lint(src, *rules, rel=PORT_REL):
    return lint_source(textwrap.dedent(src), list(rules), rel=rel)


def _key(findings):
    return [(f.rule, f.line, f.message) for f in findings]


# -- the shared cases: both analyzers, the same findings ---------------------

ANTI_ENTROPY_SWALLOW = """
    def sync_shard(self, nid):
        try:
            self.fetch_blocks(nid)
        except Exception:
            pass  # a failed poll now LOOKS like a clean pass
"""

SHARED_CASES = {
    "wallclock_flags_time_time": (["wall-clock"], """
        import time
        def span_start():
            return time.time()
    """, 1),
    "wallclock_catches_aliased_imports": (["wall-clock"], """
        from time import time as now
        import time as t
        def f():
            return now() + t.time()
    """, 2),
    "wallclock_perf_counter_and_wall_stamp_clean": (["wall-clock"], """
        import time
        def _wall_stamp():
            return time.time()
        def dur():
            return time.perf_counter()
    """, 0),
    "inline_allow_does_not_leak_to_next_line": (["wall-clock"], """
        import time
        def f():
            a = time.time()  # lint: allow(wall-clock) — display stamp
            b = time.time()
            return a, b
    """, 1),
    "wallclock_suppressed_with_reason": (["wall-clock"], """
        import time
        def f():
            # lint: allow(wall-clock) — uptime display only
            return time.time()
    """, 0),
    "swallow_catches_anti_entropy_shape": (["swallowed-exception"],
                                           ANTI_ENTROPY_SWALLOW, 1),
    "swallow_logged_counted_or_raised_is_clean": (["swallowed-exception"],
                                                  """
        def f(self):
            try:
                work()
            except Exception as e:
                self.logger.event("sync.failed", err=str(e))
        def g(self):
            try:
                work()
            except Exception:
                self.stats.count("errors")
        def h(self):
            try:
                work()
            except Exception:
                raise RuntimeError("wrapped")
        def k(self):
            try:
                work()
            except Exception as e:
                return None, e
    """, 0),
    "swallow_matches_word_stems_not_substrings": (["swallowed-exception"],
                                                  """
        def f(sock):
            try:
                work()
            except Exception:
                sock.shutdown()
        def g(xs):
            try:
                work()
            except Exception:
                n = xs.count(1)
    """, 2),
    "bare_except_flagged": (["bare-except"],
                            "try:\n    x()\nexcept:\n    pass\n", 1),
    "bare_except_named_clean": (["bare-except"],
                                "try:\n    x()\nexcept OSError:\n    pass\n",
                                0),
    "swallow_suppressed_with_reason": (["swallowed-exception"], """
        def close_all(conns):
            for c in conns:
                try:
                    c.close()
                # lint: allow(swallowed-exception) — teardown close
                except Exception:
                    pass
    """, 0),
    "thread_context_unattached_target_flagged": (["thread-context"], """
        def fan_out(self, pool):
            def work(shard):
                with qprof.stage("slice"):
                    return run(shard)
            return pool.submit(work, 1)
    """, 1),
    "thread_context_attached_target_clean": (["thread-context"], """
        def fan_out(self, pool, tracer):
            ctx = tracer.capture()
            def work(shard):
                with tracer.attach(ctx):
                    with qprof.stage("slice"):
                        return run(shard)
            return pool.submit(work, 1)
    """, 0),
    "thread_context_task_wrapped_callsite_clean": (["thread-context"], """
        def fan_out(self, pool, tracer):
            def work(shard):
                with qprof.stage("slice"):
                    return run(shard)
            return pool.submit(tracer.task(work), 1)
    """, 0),
    "tenant_attribution_untagged_acquire_and_fill": (
        ["tenant-attribution"], """
        def admit(self, q):
            self.admission.acquire()
            self.result_cache.fill(q, [])
            self.admission.acquire(tenant=q.tenant)
    """, 2),
}


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_port_and_jax_analyzers_agree(case):
    rules, src, n = SHARED_CASES[case]
    src = textwrap.dedent(src)
    port = lint_source(src, rules, rel=PORT_REL)
    ref = jax_astlint.lint_source(src, rules, rel=JAX_REL)
    assert _key(port) == _key(ref)
    assert len(port) == n, [str(f) for f in port]
    if case == "swallow_catches_anti_entropy_shape":
        assert "swallows" in port[0].message


@pytest.mark.parametrize("src", [
    "x = 1  # lint: allow(wall-clock)\n",
    '"""docs: # lint: allow(wall-clock) — nope"""\n',
    "x = 1  # lint: allow(wall-clock, bare-except) — two rules\n",
])
def test_suppression_parsing_matches_jax(src):
    port, ref = Suppressions(src), jax_astlint.Suppressions(src)
    assert port.by_line == ref.by_line
    assert port.missing_reason == ref.missing_reason


def test_suppression_without_reason_is_recorded():
    sup = Suppressions("x = 1  # lint: allow(wall-clock)\n")
    assert sup.missing_reason and sup.missing_reason[0][0] == 1


def test_docstring_text_is_not_a_suppression():
    sup = Suppressions('"""docs: # lint: allow(wall-clock) — nope"""\n')
    assert sup.by_line == {}


def test_port_drops_only_the_jax_only_rules():
    astlint._load_rules()
    jax_astlint._load_rules()
    port = set(astlint.RULES) | set(astlint.PROJECT_RULES)
    ref = set(jax_astlint.RULES) | set(jax_astlint.PROJECT_RULES)
    assert ref - port == {"traced-closure", "tier1-legs"}
    assert port <= ref


# -- the retargeted rules ----------------------------------------------------


@pytest.mark.parametrize("src,rel,n", [
    # a direct reducer call on the executor's stacked executor
    ("def run(self, plan):\n"
     "    return self.executor.stacked.segments(plan)\n", PORT_REL, 1),
    # alias tracking: a name bound to a StackedExecutor
    ("def run(self, plan, dev):\n"
     "    st = StackedExecutor(dev)\n"
     "    return st.row_counts_async('f', 'standard', plan, h, 'i', [0])\n",
     PORT_REL, 1),
    ("def run(self, plan):\n"
     "    st = self.ex.stacked\n"
     "    return st.bsi_min_max('v', 'bsig_v', plan, h, 'i', [0], True)\n",
     PORT_REL, 1),
    # inside parallel/ the reducers are the implementation
    ("def run(self, plan):\n"
     "    return self.stacked.segments(plan)\n",
     "pilosa_tpu_torch/parallel/batcher.py", 0),
    # through the batcher, and a stacked helper that is no reducer
    ("def run(self, plan):\n"
     "    return self.batcher.segments(plan)\n", PORT_REL, 0),
    ("def run(self, parts):\n"
     "    return self.stacked.merge_counts(parts)\n", PORT_REL, 0),
])
def test_batcher_bypass_targets_stacked_reducers(src, rel, n):
    assert len(lint(src, "batcher-bypass", rel=rel)) == n


@pytest.mark.parametrize("rel,n", [
    ("pilosa_tpu_torch/server/handler.py", 1),
    ("pilosa_tpu_torch/parallel/cluster.py", 0),
    ("pilosa_tpu_torch/parallel/routing.py", 0),
])
def test_router_bypass_scoped_to_port_parallel(rel, n):
    src = "def fan(self, shards):\n" \
          "    return self.placement.shards_by_node('i', shards)\n"
    assert len(lint(src, "router-bypass", rel=rel)) == n


# -- project rules on a synthetic tree ----------------------------------------

SUPPLEMENT = "pilosa_tpu_torch/analysis/catalog.md"


def _catalog(metrics="", events="", alerts="") -> str:
    return ("<!-- metrics-catalog:begin -->\n" + metrics +
            "\n<!-- metrics-catalog:end -->\n"
            "<!-- events-catalog:begin -->\n" + events +
            "\n<!-- events-catalog:end -->\n"
            "<!-- alerts-catalog:begin -->\n" + alerts +
            "\n<!-- alerts-catalog:end -->\n")


def _mini_tree(tmp_path, code, docs, supplement, extra_test=""):
    pkg = tmp_path / "pilosa_tpu_torch"
    (pkg / "analysis").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(code)
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "observability.md").write_text(docs)
    (tmp_path / SUPPLEMENT).write_text(supplement)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_x.py").write_text(extra_test)
    return tmp_path


CODE = ('FAULTS.hit("fragment.wal", key="k")\n'
        'stats.count("a.b")\n'
        'stats.gauge("port.only")\n'
        'events.emit("ev.a")\n'
        'events.emit("ev.port")\n'
        '@alert_rule("al-a")\n'
        'def a(ctx): pass\n'
        '@alert_rule("al-port")\n'
        'def b(ctx): pass\n')


def _messages(root, rule):
    return " | ".join(f"{f.path}: {f.message}"
                      for f in run_analysis(root, [rule]))


def test_catalogs_two_way_against_docs_and_supplement(tmp_path):
    root = _mini_tree(
        tmp_path, CODE + 'stats.count("un.documented")\n'
                         'events.emit("ev.undocumented")\n'
                         '@alert_rule("al-undocumented")\n'
                         'def c(ctx): pass\n',
        _catalog("| `a.b` | x |\n| `dang.ling` | y |",
                 "| `ev.a` | x |\n| `ev.dangling` | y |",
                 "| `al-a` | page | x | `/debug/alerts` |\n"
                 "| `al-dangling` | page | x | `/debug/alerts` |"),
        _catalog("| `port.only` | x |\n| `port.dangling` | y |",
                 "| `ev.port` | x |",
                 "| `al-port` | ticket | x | no runbook surface |"))
    metrics = _messages(root, "metrics-docs")
    # a site in neither catalog, a dangling row in either
    assert "un.documented" in metrics
    assert "docs/observability.md: catalog row 'dang.ling'" in metrics
    assert f"{SUPPLEMENT}: catalog row 'port.dangling'" in metrics
    # a site documented in either catalog is clean
    assert "'a.b'" not in metrics and "'port.only'" not in metrics
    events = _messages(root, "event-names")
    assert "ev.undocumented" in events and "ev.dangling" in events
    assert "'ev.a'" not in events and "'ev.port'" not in events
    alerts = _messages(root, "alert-names")
    assert "al-undocumented" in alerts and "al-dangling" in alerts
    assert f"{SUPPLEMENT}: alerts-catalog row 'al-port' has no runbook" \
        in alerts
    assert "'al-a'" not in alerts


def test_catalog_clean_tree_and_missing_supplement(tmp_path):
    root = _mini_tree(
        tmp_path, CODE,
        _catalog("| `a.b` | x |", "| `ev.a` | x |",
                 "| `al-a` | page | x | `/debug/alerts` |"),
        _catalog("| `port.only` | x |", "| `ev.port` | x |",
                 "| `al-port` | ticket | x | `/debug/slow` |"))
    for rule in ("metrics-docs", "event-names", "alert-names"):
        assert run_analysis(root, [rule]) == [], rule
    (root / SUPPLEMENT).unlink()
    for rule in ("metrics-docs", "event-names", "alert-names"):
        assert [f.message for f in run_analysis(root, [rule])] == \
            [f"{SUPPLEMENT} is missing"], rule


def test_failpoint_typo_flagged_and_real_name_clean(tmp_path):
    root = _mini_tree(
        tmp_path, CODE, _catalog(), _catalog(),
        # the bad spec is split with a `+` so THIS file's constants
        # can't match the spec shape; the generated mini-tree file
        # still contains the full typo'd literal
        extra_test='FAULTS.arm("fragment.waal")\n'
                   'FAULTS.arm("fragment.wal")\n'
                   'SPEC = "fragment.wall' + '=kill:2"\n')
    findings = run_analysis(root, ["failpoint-names"])
    assert {f.message.split("'")[1] for f in findings} == \
        {"fragment.waal", "fragment.wall"}


def test_only_port_tests_are_linted_as_tests(tmp_path):
    root = _mini_tree(tmp_path, "", _catalog(), _catalog())
    (root / "tests" / "test_other.py").write_text("")
    (root / "chip_smoke.py").write_text("")
    rels = {rel: is_test for rel, _p, is_test in astlint.iter_modules(root)}
    assert rels == {"pilosa_tpu_torch/__init__.py": False,
                    "pilosa_tpu_torch/mod.py": False,
                    "chip_smoke.py": False,
                    "tests/test_torch_x.py": True}


# -- the tree itself is clean ---------------------------------------------------


def test_repo_tree_is_clean():
    findings = run_analysis(REPO_ROOT)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_unknown_rule_id_errors():
    with pytest.raises(ValueError, match="wall-clok "):
        run_analysis(REPO_ROOT, ["wall-clok"])


def test_cli_analyze_exit_codes(tmp_path, capsys):
    assert port_cli.main(["analyze", "--root", str(REPO_ROOT)]) == 0
    root = _mini_tree(tmp_path, CODE + 'stats.count("un.documented")\n',
                      _catalog("| `a.b` | x |", "| `ev.a` | x |",
                               "| `al-a` | page | x | `/debug/alerts` |"),
                      _catalog("| `port.only` | x |", "| `ev.port` | x |",
                               "| `al-port` | ticket | x | `/debug/x` |"))
    assert port_cli.main(["analyze", "--root", str(root)]) == 1
    assert "un.documented" in capsys.readouterr().out
    assert port_cli.main(["analyze", "--root", str(tmp_path / "nope")]) == 2


def test_module_entry_point_exits_zero_on_the_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.analysis"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis: OK" in proc.stdout


# -- lockcheck: the port's runtime lock-order race detector ---------------------


@pytest.fixture
def clean_graph():
    lockcheck.GRAPH.reset()
    yield
    lockcheck.GRAPH.reset()


def _abba(lock_a, lock_b):
    import threading
    import time as _t
    bar = threading.Barrier(2)

    def one(x, y):
        with x:
            bar.wait()
            _t.sleep(0.01)
            if y.acquire(timeout=0.5):
                y.release()

    t1 = threading.Thread(target=one, args=(lock_a, lock_b))
    t2 = threading.Thread(target=one, args=(lock_b, lock_a))
    t1.start(), t2.start()
    t1.join(), t2.join()


def test_seeded_inversion_is_reported(clean_graph):
    _abba(lockcheck.CheckedLock("alpha"), lockcheck.CheckedLock("beta"))
    rep = lockcheck.report()
    kinds = {v["kind"] for v in rep["violations"]}
    assert "order-inversion" in kinds
    detail = next(v["detail"] for v in rep["violations"]
                  if v["kind"] == "order-inversion")
    assert "alpha" in detail and "beta" in detail


def test_benign_consistent_nesting_is_not_reported(clean_graph):
    import threading
    a, b = lockcheck.CheckedRLock("holder"), lockcheck.CheckedRLock("frag")

    def nest():
        with a:
            with b:
                pass

    ts = [threading.Thread(target=nest) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    rep = lockcheck.report()
    assert rep["violations"] == []
    assert any(e["from"] == "holder" and e["to"] == "frag"
               for e in rep["edges"])


def test_same_class_nesting_flagged_unless_declared(clean_graph):
    f1, f2 = lockcheck.CheckedRLock("fragment"), \
        lockcheck.CheckedRLock("fragment")
    with f1:
        with f2:
            pass
    kinds = {v["kind"] for v in lockcheck.report()["violations"]}
    assert "same-class-nesting" in kinds

    lockcheck.GRAPH.reset()
    s1, s2 = lockcheck.CheckedLock("stats"), lockcheck.CheckedLock("stats")
    with s1:
        with s2:
            pass
    assert lockcheck.report()["violations"] == []


def test_rlock_reentrancy_and_condition_bookkeeping(clean_graph):
    import threading
    import time as _t
    rl = lockcheck.CheckedRLock("holder")
    with rl:
        with rl:
            pass
    assert lockcheck.report()["violations"] == []

    cond = lockcheck.checked_condition("committer")
    hits = []

    def waiter():
        with cond:
            cond.wait(timeout=2)
            hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    _t.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join()
    assert hits == [1]


def test_cross_thread_handoff_does_not_fabricate_edges(clean_graph):
    import threading
    a = lockcheck.CheckedLock("handoff")
    b = lockcheck.CheckedLock("other")
    a.acquire()
    t = threading.Thread(target=a.release)  # legal for threading.Lock
    t.start()
    t.join()
    with b:  # the stale 'handoff' stack entry must be pruned, not held
        pass
    rep = lockcheck.report()
    assert rep["violations"] == []
    assert not any(e["from"] == "handoff" for e in rep["edges"])


def test_unarmed_factories_return_plain_primitives():
    import threading
    from pilosa_tpu_torch.utils import locks
    if locks.ARMED:
        pytest.skip("process runs with PILOSA_TPU_LOCKCHECK armed")
    assert isinstance(locks.make_lock("x"), type(threading.Lock()))
    rep = locks.report()
    assert rep["armed"] is False


STRICT_SCRIPT = """
import threading, time
from pilosa_tpu_torch.utils import locks

a = locks.make_lock("alpha")
b = locks.make_lock("beta")
bar = threading.Barrier(2)

def one(x, y):
    with x:
        bar.wait()
        time.sleep(0.01)
        if y.acquire(timeout=0.5):
            y.release()

t1 = threading.Thread(target=one, args=(a, b))
t2 = threading.Thread(target=one, args=(b, a))
t1.start(); t2.start(); t1.join(); t2.join()
print("body done")
"""


def _run_armed(script, mode):
    return subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PILOSA_TPU_LOCKCHECK": mode})


def test_strict_mode_fails_process_on_seeded_inversion():
    proc = _run_armed(STRICT_SCRIPT, "strict")
    assert "body done" in proc.stdout
    assert proc.returncode == 70, proc.stderr
    assert "order-inversion" in proc.stderr


def test_observe_mode_reports_but_exits_zero():
    proc = _run_armed(STRICT_SCRIPT, "1")
    assert proc.returncode == 0, proc.stderr
    assert "order-inversion" in proc.stderr


# -- GET /debug/locks on a port server ------------------------------------------

LOCKS_SCRIPT = """
import json, sys, tempfile, urllib.request
from pilosa_tpu_torch.server.server import Config, Server
with tempfile.TemporaryDirectory() as d:
    s = Server(Config(data_dir=d, bind="localhost:0", device="cpu",
                      metric_poll_interval=0, warmup_top_n=0,
                      timeseries_interval=0, flight_recorder_mb=0))
    s.open()
    try:
        with urllib.request.urlopen(
                f"http://localhost:{s.port}/debug/locks", timeout=30) as r:
            print("LOCKS", r.status, json.dumps(json.loads(r.read())))
    finally:
        s.close()
"""


@pytest.mark.parametrize("mode", ["", "1"])
def test_debug_locks_route_answers(mode):
    proc = _run_armed(LOCKS_SCRIPT, mode)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("LOCKS "))
    _, status, body = line.split(" ", 2)
    rep = json.loads(body)
    assert status == "200"
    assert rep["armed"] is (mode == "1")
    if mode:
        assert rep["mode"] == "1"
        assert set(rep) == {"mode", "armed", "lockClasses", "edges",
                            "violations"}
    else:
        assert rep == {"mode": "off", "armed": False, "lockClasses": [],
                       "edges": [], "violations": []}

