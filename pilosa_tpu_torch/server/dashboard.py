"""/debug/dashboard: a zero-dependency single-file HTML view of the
in-process time-series ring (docs/observability.md "Device runtime").

The page polls /debug/timeseries (and /debug/vars for the header line)
on the ring's own cadence and renders inline-SVG sparklines — no
external scripts, fonts, or build step, so "what happened in the last
10 minutes" is answerable from the node itself with nothing but a
browser pointed at it.  All numbers come from the ring's samples; the
page does no aggregation beyond per-sample ratios.

Port copy of the JAX package's ``server/dashboard.py`` (both pages).  On
the port the "compiles" series count CUDA graph captures (utils/devobs.py)
and the "HBM" series the card's device budget."""

DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>pilosa-tpu dashboard</title>
<style>
  :root { color-scheme: dark; }
  body { margin: 0; padding: 16px 20px; background: #14161a;
         color: #d6d9de; font: 13px/1.45 system-ui, sans-serif; }
  h1 { font-size: 15px; margin: 0 0 2px; font-weight: 600; }
  #meta { color: #8a8f98; margin-bottom: 14px; }
  #grid { display: grid; gap: 12px;
          grid-template-columns: repeat(auto-fill, minmax(330px, 1fr)); }
  .card { background: #1b1e24; border: 1px solid #262a31;
          border-radius: 6px; padding: 10px 12px 6px; }
  .card h2 { font-size: 12px; margin: 0 0 4px; font-weight: 600;
             color: #aab0b9; }
  .card .now { float: right; color: #e8eaed; font-variant-numeric:
               tabular-nums; }
  svg { width: 100%; height: 64px; display: block; }
  .axis { color: #6b7077; font-size: 10px; display: flex;
          justify-content: space-between; }
  .err { color: #e07a5f; }
  #alerts { margin: 0 0 12px; }
  #alerts:empty { display: none; }
  .alert { display: inline-block; margin: 0 8px 4px 0; padding: 3px 9px;
           border-radius: 4px; font-size: 12px; background: #2a1e22;
           border: 1px solid #f7768e; color: #f7768e; }
  .alert.ticket { background: #2a2620; border-color: #e0af68;
                  color: #e0af68; }
</style>
</head>
<body>
<h1>pilosa-tpu &middot; device runtime
  <a href="/debug/dashboard/cluster" style="font-size:11px;
     color:#7aa2f7; margin-left:10px">fleet view &rarr;</a></h1>
<div id="meta">loading&hellip;</div>
<div id="alerts"></div>
<div id="grid"></div>
<script>
"use strict";
const COLORS = ["#7aa2f7", "#9ece6a", "#e0af68", "#f7768e", "#bb9af7"];
const MB = b => b / 1048576;
const CHARTS = [
  {title: "qps", unit: "q/s",
   series: [{label: "queries", f: (s, dt) => s.httpQueriesDelta / dt}]},
  {title: "p99 latency", unit: "ms",
   series: [{label: "http.query", f: s => s.httpQueryP99Ms}]},
  {title: "HBM residency", unit: "MB",
   series: [{label: "compressed", f: s => MB(s.hbmCompressedBytes)},
            {label: "dense", f: s => MB(s.hbmDenseBytes)},
            {label: "pinned", f: s => MB(s.hbmPinnedBytes)}]},
  {title: "evictions / uploads", unit: "/s",
   series: [{label: "evictions", f: (s, dt) => s.evictionsDelta / dt},
            {label: "upload MB", f: (s, dt) =>
                MB(s.uploadBytesDelta) / dt}]},
  {title: "compiles &amp; retraces", unit: "/interval",
   series: [{label: "compiles", f: s => s.compilesDelta},
            {label: "retraces", f: s => s.retracesDelta}]},
  {title: "compile seconds", unit: "s/interval",
   series: [{label: "compile s", f: s => s.compileSDelta}]},
  {title: "queue depth", unit: "",
   series: [{label: "admission", f: s => s.admissionInUse +
                s.admissionWaiting},
            {label: "batcher", f: s => s.batcherQueued}]},
  {title: "launch padding waste", unit: "%",
   series: [{label: "padded", f: s => {
       const t = s.rowsActualDelta + s.rowsPaddedDelta;
       return t ? 100 * s.rowsPaddedDelta / t : 0; }}]},
  {title: "decode workspace peak", unit: "MB",
   series: [{label: "peak", f: s => MB(s.decodePeakBytes)}]},
  {title: "cluster health", unit: "/interval",
   series: [{label: "hedges", f: s => s.hedgesDelta},
            {label: "retry waves", f: s => s.retryWavesDelta},
            {label: "partial", f: s => s.partialResultsDelta},
            {label: "route fallback", f: s => s.routingFallbacksDelta},
            {label: "handoffs", f: s => s.balancerHandoffsDelta}]},
  {title: "fleet events", unit: "/interval",
   series: [{label: "events", f: s => s.fleetEventsDelta}]},
  {title: "kernel launches", unit: "/s",
   series: [{label: "launches", f: (s, dt) => s.kernelLaunchesDelta / dt},
            {label: "tiles", f: (s, dt) => s.kernelTilesDelta / dt}]},
  {title: "tenant sheds", unit: "/interval",
   series: [{label: "sheds", f: s => s.tenantShedsDelta}]},
];
function fmt(v) {
  if (!isFinite(v)) return "-";
  if (Math.abs(v) >= 1000) return v.toFixed(0);
  if (Math.abs(v) >= 10) return v.toFixed(1);
  return v.toFixed(2);
}
function spark(rows) {
  const w = 320, h = 60, n = rows[0].length;
  let lo = Infinity, hi = -Infinity;
  for (const r of rows) for (const v of r) {
    if (isFinite(v)) { lo = Math.min(lo, v); hi = Math.max(hi, v); }
  }
  if (!isFinite(lo)) { lo = 0; hi = 1; }
  if (hi - lo < 1e-9) { hi = lo + 1; }
  const x = i => n < 2 ? w : i * w / (n - 1);
  const y = v => h - 4 - (v - lo) * (h - 8) / (hi - lo);
  let paths = "";
  rows.forEach((r, k) => {
    const pts = r.map((v, i) =>
      `${x(i).toFixed(1)},${y(isFinite(v) ? v : lo).toFixed(1)}`);
    paths += `<polyline fill="none" stroke="${COLORS[k % 5]}"
      stroke-width="1.5" points="${pts.join(" ")}"/>`;
  });
  return {svg: `<svg viewBox="0 0 ${w} ${h}"
    preserveAspectRatio="none">${paths}</svg>`, lo, hi};
}
function render(ts, vars) {
  const s = ts.samples || [];
  const dt = ts.intervalS || 1;
  const last = s[s.length - 1] || {};
  const counts = (vars && vars.counts) || {};
  document.getElementById("meta").textContent =
    `interval ${ts.intervalS}s · window ${ts.windowS}s · ` +
    `${s.length}/${ts.capacity} samples (${ts.coveredS}s covered) · ` +
    `queries served ${counts["query"] || 0} · ` +
    `up ${Math.round(last.uptimeS || 0)}s`;
  const active = ((vars && vars.alerts) || {}).active || {};
  document.getElementById("alerts").innerHTML =
    Object.keys(active).sort().map(id => {
      const a = active[id];
      return `<span class="alert ${a.severity}" title="${a.detail ||
        ""}">&#9888; ${id}</span>`;
    }).join("");
  const grid = document.getElementById("grid");
  grid.innerHTML = "";
  for (const c of CHARTS) {
    const rows = c.series.map(ser => s.map(p => ser.f(p, dt)));
    const {svg, lo, hi} = spark(rows.length ? rows : [[0]]);
    const now = rows.map((r, k) =>
      `<span style="color:${COLORS[k % 5]}">${c.series[k].label} ` +
      `${fmt(r[r.length - 1] ?? 0)}</span>`).join(" &middot; ");
    const card = document.createElement("div");
    card.className = "card";
    card.innerHTML = `<h2>${c.title} <span class="now">${now}` +
      ` ${c.unit}</span></h2>${svg}` +
      `<div class="axis"><span>${fmt(lo)}</span>` +
      `<span>${fmt(hi)} ${c.unit}</span></div>`;
    grid.appendChild(card);
  }
}
async function tick() {
  try {
    const [ts, vars] = await Promise.all([
      fetch("/debug/timeseries").then(r => r.json()),
      fetch("/debug/vars").then(r => r.json()).catch(() => null),
    ]);
    render(ts, vars);
    setTimeout(tick, Math.max((ts.intervalS || 5) * 1000, 1000));
  } catch (e) {
    document.getElementById("meta").innerHTML =
      `<span class="err">fetch failed: ${e}</span>`;
    setTimeout(tick, 5000);
  }
}
tick();
</script>
</body>
</html>
"""

# /debug/dashboard/cluster: the fleet page (docs/observability.md
# "Cluster plane") — a per-node table of the rollup summaries (stale
# nodes dimmed and flagged) plus the merged event timeline, polled from
# /debug/cluster on its TTL cadence.  Same zero-dependency discipline
# as the node page.
CLUSTER_DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>pilosa-tpu fleet</title>
<style>
  :root { color-scheme: dark; }
  body { margin: 0; padding: 16px 20px; background: #14161a;
         color: #d6d9de; font: 13px/1.45 system-ui, sans-serif; }
  h1 { font-size: 15px; margin: 0 0 2px; font-weight: 600; }
  h2 { font-size: 13px; margin: 18px 0 6px; font-weight: 600;
       color: #aab0b9; }
  #meta { color: #8a8f98; margin-bottom: 14px; }
  table { border-collapse: collapse; width: 100%;
          font-variant-numeric: tabular-nums; }
  th, td { text-align: right; padding: 3px 10px;
           border-bottom: 1px solid #262a31; font-size: 12px; }
  th { color: #8a8f98; font-weight: 500; }
  th:first-child, td:first-child { text-align: left; }
  tr.stale td { color: #6b7077; }
  .down { color: #f7768e; }
  .flag { color: #e0af68; }
  #timeline { font: 11px/1.6 ui-monospace, monospace; color: #aab0b9;
              max-height: 320px; overflow-y: auto; background: #1b1e24;
              border: 1px solid #262a31; border-radius: 6px;
              padding: 8px 12px; }
  .ev { color: #7aa2f7; }
  .err { color: #e07a5f; }
</style>
</head>
<body>
<h1>pilosa-tpu &middot; fleet
  <a href="/debug/dashboard" style="font-size:11px; color:#7aa2f7;
     margin-left:10px">&larr; node view</a></h1>
<div id="meta">loading&hellip;</div>
<h2>nodes</h2>
<table id="nodes"><thead><tr>
  <th>node</th><th>state</th><th>qps</th><th>p99 ms</th>
  <th>HBM MB</th><th>evict</th><th>retrace</th><th>hedges</th>
  <th>waves</th><th>partial</th><th>quar</th><th>ingest MB</th>
  <th>alerts</th><th>stale s</th>
</tr></thead><tbody></tbody></table>
<h2>fleet timeline</h2>
<div id="timeline"></div>
<script>
"use strict";
const MB = b => (b / 1048576).toFixed(0);
function render(c) {
  const nodes = c.nodes || {};
  document.getElementById("meta").textContent =
    `coordinator ${c.coordinator} · epoch ${c.epoch} · ` +
    `overlay ${c.overlayEpoch} · refreshes ${c.refreshes} · ` +
    `fetch errors ${c.fetchErrors}`;
  const tb = document.querySelector("#nodes tbody");
  tb.innerHTML = "";
  for (const nid of Object.keys(nodes).sort()) {
    const n = nodes[nid];
    const tr = document.createElement("tr");
    if (n.stale) tr.className = "stale";
    const cells = [
      nid,
      n.state === "READY" ? "READY" :
        `<span class="down">${n.state}</span>`,
      (n.qps ?? 0).toFixed(1),
      n.p99Ms ?? "-",
      MB(n.hbmResidentBytes || 0),
      n.evictions ?? "-",
      n.retraces ?? "-",
      `${n.hedges ?? "-"}/${n.hedgeWins ?? "-"}`,
      n.retryWaves ?? "-",
      n.partialResults ?? "-",
      n.quarantinedFragments ?
        `<span class="flag">${n.quarantinedFragments}</span>` : 0,
      MB(n.ingestBacklogBytes || 0),
      n.activeAlerts ? `<span class="down" title="${
        (n.alertIds || []).join(", ")}">${n.activeAlerts}</span>` : 0,
      n.stale ? `<span class="flag">${
        n.staleS != null ? n.staleS.toFixed(0) : "?"}</span>` : "",
    ];
    tr.innerHTML = cells.map(x => `<td>${x}</td>`).join("");
    tb.appendChild(tr);
  }
  const tl = document.getElementById("timeline");
  tl.innerHTML = (c.timeline || []).slice(-200).reverse().map(e => {
    const when = e.wall ?
      new Date(e.wall * 1000).toISOString().slice(11, 19) : "-";
    const rest = Object.entries(e).filter(
      ([k]) => !["event", "node", "wall", "seq"].includes(k))
      .map(([k, v]) => `${k}=${JSON.stringify(v)}`).join(" ");
    return `${when} <b>${e.node || "?"}</b> ` +
      `<span class="ev">${e.event}</span> ${rest}`;
  }).join("<br>") || "no events yet";
}
async function tick() {
  try {
    const c = await fetch("/debug/cluster").then(r => r.json());
    render(c);
    setTimeout(tick, Math.max((c.ttlS || 2) * 1000, 1000));
  } catch (e) {
    document.getElementById("meta").innerHTML =
      `<span class="err">fetch failed: ${e}</span>`;
    setTimeout(tick, 5000);
  }
}
tick();
</script>
</body>
</html>
"""
