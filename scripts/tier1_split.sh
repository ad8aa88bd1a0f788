#!/usr/bin/env bash
# Tier-1 verify, split into two legs (the PR 5/13/14 precedent, codified
# at PR 16): on a 1-core box the full suite no longer fits one 870 s
# timeout budget, so it runs as two halves with the SAME pytest flags as
# ROADMAP.md's single-command tier-1 line.  Each leg gets its own 870 s
# budget and prints its own DOTS_PASSED count.
#
#   scripts/tier1_split.sh        # both legs, exit non-zero if either fails
#   scripts/tier1_split.sh 1      # just leg 1 (core / single-node)
#   scripts/tier1_split.sh 2      # just leg 2 (cluster / distributed / bench)
#
# The leg partition is CHECKED: the analyzer's tier1-legs rule
# (pilosa_tpu/analysis/rules/tier1_legs.py, docs/static-analysis.md)
# fails if any tests/test_*.py on disk is missing from both lists below
# or a listed file no longer exists, and _check_partition here re-checks
# at run time — a new test file cannot silently fall outside tier-1.
set -uo pipefail
cd "$(dirname "$0")/.."

# Leg 1: core engine + storage + single-node serving.
LEG1="
tests/test_analysis.py
tests/test_batcher.py
tests/test_bitset.py
tests/test_bsi.py
tests/test_budget_stream.py
tests/test_cache.py
tests/test_cli.py
tests/test_containers.py
tests/test_crash.py
tests/test_device_obs.py
tests/test_differential.py
tests/test_durability.py
tests/test_events.py
tests/test_executor.py
tests/test_explain.py
tests/test_fuzz.py
tests/test_ingest.py
tests/test_kernels.py
tests/test_native.py
tests/test_observability.py
tests/test_pql.py
tests/test_prepared.py
tests/test_roaring_golden.py
tests/test_storage.py
tests/test_torch_batcher.py
tests/test_torch_bitset.py
tests/test_torch_budget_stream.py
tests/test_torch_containers.py
tests/test_torch_executor.py
tests/test_torch_ingest.py
tests/test_torch_native.py
tests/test_torch_server.py
tests/test_torch_storage.py
tests/test_torch_wholequery.py
tests/test_torch_mesh.py
tests/test_translate.py
tests/test_wholequery.py
tests/test_torch_devobs.py
tests/test_torch_spans.py
tests/test_torch_analysis.py
tests/test_torch_crash.py
tests/test_torch_durability.py
tests/test_torch_roaring_golden.py
tests/test_torch_translate.py
tests/test_torch_cache.py
tests/test_torch_events.py
tests/test_torch_explain.py
tests/test_torch_pql.py
tests/test_torch_cli.py
tests/test_torch_observability.py
tests/test_torch_bench_cluster.py
"

# Leg 2: cluster plane (fan-out, chaos, routing, resize, wire) + server
# + bench smoke.
LEG2="
tests/test_bench_smoke.py
tests/test_churn.py
tests/test_cluster.py
tests/test_cluster_differential.py
tests/test_cluster_obs.py
tests/test_multihost.py
tests/test_overload.py
tests/test_parallel.py
tests/test_qwire.py
tests/test_routing.py
tests/test_server.py
tests/test_slo.py
tests/test_tenant.py
tests/test_topology.py
tests/test_torch_antientropy.py
tests/test_torch_balancer.py
tests/test_torch_churn.py
tests/test_torch_cluster.py
tests/test_torch_cluster_diff.py
tests/test_torch_cluster_obs.py
tests/test_torch_cluster_tls.py
tests/test_torch_qwire.py
tests/test_torch_resize.py
tests/test_warmup.py
tests/test_torch_warmup.py
tests/test_torch_slo.py
tests/test_torch_multihost.py
tests/test_torch_overload.py
tests/test_torch_tenant.py
tests/test_torch_routing.py
tests/test_torch_topology.py
tests/test_torch_bench.py
"

_check_partition() {
    local missing=0
    for f in tests/test_*.py; do
        # no grep -q here: under pipefail, -q exits on first match and
        # can SIGPIPE the printf, failing the pipeline on a MATCH
        if ! printf '%s\n%s\n' "$LEG1" "$LEG2" | grep -x "$f" >/dev/null; then
            echo "tier1_split.sh: $f is in NEITHER leg — add it" >&2
            missing=1
        fi
    done
    for f in $LEG1 $LEG2; do
        if [ ! -f "$f" ]; then
            echo "tier1_split.sh: $f is listed but does not exist" >&2
            missing=1
        fi
    done
    return $missing
}

_run_leg() {
    local name="$1"; shift
    local log="/tmp/_t1_${name}.log"
    rm -f "$log"
    # shellcheck disable=SC2086  # word-splitting the file list is the point
    timeout -k 10 870 env JAX_PLATFORMS=cpu python -m pytest $* -q \
        -m 'not slow' --continue-on-collection-errors \
        -p no:cacheprovider -p no:xdist -p no:randomly 2>&1 | tee "$log"
    local rc=${PIPESTATUS[0]}
    echo "LEG${name}_DOTS_PASSED=$(grep -aE \
        '^[.FEsx]+( *\[ *[0-9]+%\])?$' "$log" | tr -cd . | wc -c)"
    return $rc
}

_check_partition || exit 1

rc=0
case "${1:-all}" in
    1) _run_leg 1 $LEG1 || rc=$? ;;
    2) _run_leg 2 $LEG2 || rc=$? ;;
    all)
        _run_leg 1 $LEG1 || rc=$?
        _run_leg 2 $LEG2 || rc=$?
        ;;
    *) echo "usage: $0 [1|2]" >&2; exit 2 ;;
esac
exit $rc
