"""Zero-dependency live engine dashboard (``GET /dashboard``).

One self-contained HTML page — inline CSS, inline JS, canvas sparklines,
no npm, no CDN, no external URL of any kind (the ``dashboard-static``
dlint rule enforces that this module stays that way). It polls the same
JSON endpoints everything else uses:

* ``/v1/debug/series?name=&window=`` for per-series points (the
  in-process time-series store, obs/timeseries.py);
* ``/v1/health`` for the status badge (composed watchdog + anomaly
  degraded reasons).

The default panel set covers the signals an operator watches first
(lanes, queue, goodput, TTFT/TPOT, decode stall, KV free pages); a text
box adds any other series the store tracks. Rendering is deliberately
dumb — a fetch loop and ~40 lines of canvas — because the page must
work from ``curl -o dash.html`` on an air-gapped host.

The SAME page serves as the fleet dashboard on the JAX package's fleet router:
when the series index advertises ``dllama_fleet_goodput_tokens_per_s``,
the fleet default panels (aggregate goodput, TPOT skew, per-replica
TPOT, affinity hit rate, failovers) are appended, and every panel
overlays the ``replica``-labelled variants of its base series as
separate colored lines — one sparkline per replica, the skew visible at
a glance.
"""

from __future__ import annotations

DASHBOARD_CONTENT_TYPE = "text/html; charset=utf-8"

# NOTE: keep this template free of external references — no scheme
# (``//``), no ``<script src``, no ``<link href``, no ``@import``. The
# dashboard-static dlint rule scans this module's source.
DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>dllama-tpu — live engine</title>
<style>
  body { background:#111418; color:#d8dee4; margin:0;
         font:13px/1.4 ui-monospace, monospace; }
  header { display:flex; align-items:center; gap:1em;
           padding:10px 16px; border-bottom:1px solid #2a2f36; }
  h1 { font-size:15px; margin:0; font-weight:600; }
  #status { padding:2px 10px; border-radius:10px; font-weight:600; }
  #status.ok { background:#1d3b24; color:#7ce38b; }
  #status.degraded { background:#4a1d1d; color:#ff8f8f; }
  #reasons { color:#ff8f8f; }
  #grid { display:grid; grid-template-columns:repeat(auto-fill,minmax(320px,1fr));
          gap:10px; padding:12px 16px; }
  .panel { background:#171b21; border:1px solid #2a2f36; border-radius:6px;
           padding:8px 10px; }
  .panel .name { color:#8b949e; overflow:hidden; text-overflow:ellipsis;
                 white-space:nowrap; }
  .panel .val { font-size:16px; font-weight:600; }
  canvas { width:100%; height:46px; display:block; margin-top:4px; }
  select, input { background:#171b21; color:#d8dee4;
                  border:1px solid #2a2f36; border-radius:4px; padding:2px 6px; }
  footer { color:#8b949e; padding:0 16px 12px; }
</style>
</head>
<body>
<header>
  <h1>dllama-tpu</h1>
  <span id="status" class="ok">…</span>
  <span id="reasons"></span>
  <label>window
    <select id="window">
      <option value="60">1m</option>
      <option value="300" selected>5m</option>
      <option value="600">10m</option>
      <option value="3600">1h</option>
    </select>
  </label>
  <input id="add" list="names" placeholder="add series…" size="34">
  <datalist id="names"></datalist>
</header>
<div id="grid"></div>
<footer>polling /v1/debug/series every 2s — single-file dashboard, no
external assets</footer>
<script>
"use strict";
const DEFAULTS = [
  "dllama_lanes_active",
  "dllama_queue_depth",
  'dllama_slo_goodput_tokens_per_s{window="1m"}',
  'dllama_slo_throughput_tokens_per_s{window="1m"}',
  "dllama_ttft_seconds_p50",
  "dllama_tpot_seconds_p50",
  "dllama_decode_stall_seconds_p99",
  "dllama_kv_pages_free",
  "dllama_spec_acceptance_rate",
  'dllama_admission_predict_error_ms_p50{signal="ttft"}',
];
const FLEET_DEFAULTS = [
  "dllama_fleet_goodput_tokens_per_s",
  "dllama_fleet_tpot_skew_ms",
  "dllama_fleet_replica_tpot_p50_ms",
  "dllama_fleet_affinity_hit_rate",
  "dllama_router_failovers_total",
];
const PALETTE = ["#58a6ff", "#7ce38b", "#ffa657", "#d2a8ff",
                 "#ff8f8f", "#79c0ff"];
let series = DEFAULTS.slice();
let fleetAdded = false;
let indexNames = [];
const grid = document.getElementById("grid");
const panels = {};

function panelFor(name) {
  if (panels[name]) return panels[name];
  const div = document.createElement("div");
  div.className = "panel";
  div.innerHTML = '<div class="name"></div><div class="val">—</div><canvas></canvas>';
  div.querySelector(".name").textContent = name;
  grid.appendChild(div);
  panels[name] = div;
  return div;
}

function spark(canvas, lines) {
  // lines: array of point arrays, one colored polyline each (line 0 is
  // the base series; 1.. are per-replica overlays). Shared y-scale so
  // replica skew reads directly off the vertical spread.
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth * dpr, h = canvas.clientHeight * dpr;
  canvas.width = w; canvas.height = h;
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, w, h);
  let lo = Infinity, hi = -Infinity, t0 = Infinity, t1 = -Infinity;
  for (const pts of lines) {
    for (const [t, v] of pts) {
      lo = Math.min(lo, v); hi = Math.max(hi, v);
      t0 = Math.min(t0, t); t1 = Math.max(t1, t);
    }
  }
  if (!isFinite(lo)) return;
  if (hi === lo) { hi = lo + 1; }
  lines.forEach((pts, li) => {
    if (pts.length < 2) return;
    ctx.strokeStyle = PALETTE[li % PALETTE.length];
    ctx.lineWidth = 1.5 * dpr; ctx.beginPath();
    pts.forEach(([t, v], i) => {
      const x = ((t - t0) / Math.max(t1 - t0, 1e-9)) * (w - 2) + 1;
      const y = h - 3 - ((v - lo) / (hi - lo)) * (h - 6);
      if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
    });
    ctx.stroke();
  });
}

function replicaVariants(name) {
  // the router's series store tracks the scraped per-replica children
  // as name{replica="r0",...}; overlay them on the base panel
  if (name.includes("{")) return [];
  const prefix = name + "{";
  return indexNames.filter(
    (n) => n.startsWith(prefix) && n.includes('replica="'));
}

async function getJSON(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(url + " -> " + r.status);
  return r.json();
}

function fmt(v) {
  if (v === null || v === undefined) return "—";
  const a = Math.abs(v);
  if (a >= 1000) return v.toFixed(0);
  if (a >= 1) return v.toFixed(2);
  return v.toFixed(4);
}

async function tick() {
  const win = document.getElementById("window").value;
  try {
    const health = await getJSON("/v1/health");
    const badge = document.getElementById("status");
    badge.textContent = health.status;
    badge.className = health.status === "ok" ? "ok" : "degraded";
    document.getElementById("reasons").textContent =
      (health.degraded_reasons || []).join("  ·  ");
  } catch (e) { /* server restarting; keep polling */ }
  try {
    const idx = await getJSON("/v1/debug/series");
    indexNames = idx.names || [];
    const dl = document.getElementById("names");
    dl.innerHTML = "";
    for (const n of indexNames) {
      const o = document.createElement("option");
      o.value = n; dl.appendChild(o);
    }
    if (!fleetAdded &&
        indexNames.includes("dllama_fleet_goodput_tokens_per_s")) {
      // we are pointed at a fleet router: append the fleet panels once
      fleetAdded = true;
      for (const n of FLEET_DEFAULTS) {
        if (!series.includes(n)) series.push(n);
      }
    }
  } catch (e) { /* ignore */ }
  for (const name of series) {
    const div = panelFor(name);
    const lines = [];
    let last = null;
    for (const n of [name].concat(replicaVariants(name))) {
      try {
        const s = await getJSON(
          "/v1/debug/series?name=" + encodeURIComponent(n) +
          "&window=" + win);
        const pts = s.points || [];
        lines.push(pts);
        if (last === null && pts.length) last = pts[pts.length - 1][1];
      } catch (e) { /* series missing; panel shows a dash */ }
    }
    div.querySelector(".val").textContent = fmt(last);
    spark(div.querySelector("canvas"), lines);
  }
}

document.getElementById("add").addEventListener("change", (ev) => {
  const name = ev.target.value.trim();
  if (name && !series.includes(name)) { series.push(name); panelFor(name); }
  ev.target.value = "";
});

tick();
setInterval(tick, 2000);
</script>
</body>
</html>
"""


def render_dashboard() -> bytes:
    """The dashboard page as UTF-8 bytes (what ``GET /dashboard``
    writes)."""
    return DASHBOARD_HTML.encode("utf-8")
