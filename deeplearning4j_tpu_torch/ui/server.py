"""UIServer: the training dashboard.

Parity: reference ``deeplearning4j-play/.../PlayUIServer.java`` +
``api/UIServer.java`` (``getInstance().attach(statsStorage)``) and the
``TrainModule`` overview (score chart, model info, system tab) — re-done as a
dependency-free stdlib HTTP server: JSON endpoints + one self-contained HTML
page with inline SVG charts. Counterpart of the JAX package's
``ui/server.py``: the same endpoints and the same JSON over the same
stored records.

Endpoints:
  GET  /                    dashboard page
  GET  /api/sessions        session ids
  GET  /api/overview?sid=   score series + timing + memory
  GET  /api/static?sid=     model/static info
  GET  /api/histograms?sid= latest param/update histograms + norm series
                            (parity: HistogramModule)
  GET  /api/flow?sid=       network topology nodes+edges from config JSON
                            (parity: FlowListenerModule)
  GET  /api/activations?sid= latest conv activation grid
                            (parity: ConvolutionalListenerModule)
  GET  /api/tsne?sid=       stored t-SNE embedding (parity: TsneModule)
  GET  /metrics             Prometheus text exposition of the attached
                            metrics registry (process default unless one
                            is passed to UIServer)
  GET  /debug/flightrecorder the process flight recorder's event ring
                            (util/flightrecorder.py)
  GET  /debug/timeline      the process-default tracer's traces, nested
                            by parentage (util/timeline.py); optional
                            ?trace_id= filter. Requests carrying a
                            ``traceparent`` header join the caller's
                            trace (one ui.request span, header echoed)
  GET  /debug/health        training-health telemetry (util/health.py):
                            latest rule report, stats snapshot, and NaN
                            layer-of-origin attribution
  POST /profile?seconds=N   capture a torch.profiler device trace for N
                            seconds (409 while one is in progress) —
                            profile the TRAINING process the dashboard
                            watches without touching its code
  POST /api/tsne            upload coords, or raw vectors to embed (the
                            embedding needs ``plot.tsne``, not ported:
                            a 400 naming it)
  POST /api/remote          receive stats records POSTed by
                            RemoteUIStatsStorageRouter from other hosts
                            (parity: RemoteReceiverModule)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from ..storage.stats_storage import StatsStorage
from ..util import metrics as _metrics
from ..util import tracing as _tracing

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu training UI</title>
<style>
 body{font-family:sans-serif;margin:2em;background:#fafafa}
 h1{font-size:1.3em} .card{background:#fff;border:1px solid #ddd;
 border-radius:6px;padding:1em;margin-bottom:1em;max-width:900px}
 svg{width:100%;height:260px} pre{white-space:pre-wrap}
</style></head><body>
<h1>deeplearning4j_tpu — training overview</h1>
<div class="card"><b>Session:</b> <select id="sid"></select></div>
<div class="card"><b>Score vs iteration</b><svg id="score"></svg></div>
<div class="card"><b>Iteration time (ms)</b><svg id="timing"></svg></div>
<div class="card"><b>Parameter histograms</b> (latest snapshot)
 <div id="hists"></div></div>
<div class="card"><b>Update:param ratio (log10)</b><svg id="ratios"></svg>
 <div id="ratio_legend" style="font-size:11px"></div></div>
<div class="card"><b>Network flow</b><svg id="flow" style="height:auto"></svg></div>
<div class="card"><b>Conv activations</b> (latest probe)
 <div id="acts" style="font-size:11px"></div></div>
<div class="card"><b>t-SNE</b> (uploaded / embedded points)
 <svg id="tsne" style="height:420px"></svg></div>
<div class="card"><b>Model</b><pre id="model"></pre></div>
<script>
async function j(u){return (await fetch(u)).json()}
function line(svg, xs, ys, color){
  const el=document.getElementById(svg); el.innerHTML='';
  if(!xs.length) return;
  const W=900,H=260,P=35;
  const xmin=Math.min(...xs),xmax=Math.max(...xs)||1;
  const ymin=Math.min(...ys),ymax=Math.max(...ys)||1;
  const sx=x=>P+(x-xmin)/(xmax-xmin||1)*(W-2*P);
  const sy=y=>H-P-(y-ymin)/(ymax-ymin||1)*(H-2*P);
  let d='M'+xs.map((x,i)=>sx(x)+','+sy(ys[i])).join(' L');
  el.innerHTML=`<path d="${d}" fill="none" stroke="${color}" stroke-width="1.5"/>
   <text x="5" y="15" font-size="11">${ymax.toPrecision(4)}</text>
   <text x="5" y="${H-8}" font-size="11">${ymin.toPrecision(4)}</text>`;
}
function multiline(svgId, series, legendId){
  const el=document.getElementById(svgId); el.innerHTML='';
  const names=Object.keys(series); if(!names.length) return;
  const W=900,H=260,P=35;
  const colors=['#1565c0','#e65100','#2e7d32','#c62828','#6a1b9a',
                '#00838f','#f9a825','#4e342e'];
  let xmin=1e99,xmax=-1e99,ymin=1e99,ymax=-1e99;
  for(const n of names){
    for(const x of series[n].xs){xmin=Math.min(xmin,x);xmax=Math.max(xmax,x)}
    for(const y of series[n].ys){ymin=Math.min(ymin,y);ymax=Math.max(ymax,y)}
  }
  const sx=x=>P+(x-xmin)/(xmax-xmin||1)*(W-2*P);
  const sy=y=>H-P-(y-ymin)/(ymax-ymin||1)*(H-2*P);
  let out='',leg='';
  names.forEach((n,i)=>{
    const c=colors[i%colors.length], s=series[n];
    out+=`<path d="M${s.xs.map((x,k)=>sx(x)+','+sy(s.ys[k])).join(' L')}"
      fill="none" stroke="${c}" stroke-width="1.2"/>`;
    leg+=`<span style="color:${c}">&#9632; ${n}</span> `;
  });
  out+=`<text x="5" y="15" font-size="11">${ymax.toPrecision(3)}</text>
   <text x="5" y="${H-8}" font-size="11">${ymin.toPrecision(3)}</text>`;
  el.innerHTML=out;
  if(legendId) document.getElementById(legendId).innerHTML=leg;
}
function histSvg(h, color){
  const W=280,H=90,n=h.counts.length;
  const m=Math.max(...h.counts)||1;
  let rects='';
  h.counts.forEach((c,i)=>{
    const bh=(c/m)*(H-18);
    rects+=`<rect x="${i*W/n}" y="${H-16-bh}" width="${W/n-1}"
      height="${bh}" fill="${color}"/>`;
  });
  return `<svg style="width:${W}px;height:${H}px">${rects}
    <text x="0" y="${H-3}" font-size="9">${h.min.toPrecision(3)}</text>
    <text x="${W-55}" y="${H-3}" font-size="9">${h.max.toPrecision(3)}</text>
  </svg>`;
}
async function refresh(){
  const sid=document.getElementById('sid').value;
  if(!sid) return;
  const o=await j('/api/overview?sid='+sid);
  line('score', o.iterations, o.scores, '#1565c0');
  line('timing', o.iterations.slice(1), o.timings.slice(1), '#e65100');
  const hg=await j('/api/histograms?sid='+sid);
  const hd=document.getElementById('hists'); hd.innerHTML='';
  if(hg.latest.parameters){
    for(const [name,entry] of Object.entries(hg.latest.parameters)){
      let cell=`<div style="display:inline-block;margin:4px;
        vertical-align:top"><div style="font-size:11px">${name}
        &nbsp;|W|=${entry.norm.toPrecision(3)}</div>`;
      cell+=histSvg(entry.histogram,'#1565c0');
      if(entry.update) cell+=histSvg(entry.update.histogram,'#e65100');
      hd.innerHTML+=cell+'</div>';
    }
  }
  const series={};
  for(const [name,s] of Object.entries(hg.norm_series)){
    const ys=s.update_ratios.map(r=>r>0?Math.log10(r):-10);
    if(s.iterations.length>1) series[name]={xs:s.iterations, ys:ys};
  }
  multiline('ratios', series, 'ratio_legend');
  const s=await j('/api/static?sid='+sid);
  document.getElementById('model').textContent=JSON.stringify(s,null,1);
  flowChart(await j('/api/flow?sid='+sid));
  actGrid(await j('/api/activations?sid='+sid));
  tsneChart(await j('/api/tsne?sid='+sid));
}
function flowChart(g){
  const el=document.getElementById('flow'); el.innerHTML='';
  if(!g.nodes.length) return;
  // layered left-to-right layout: depth = longest path from an input
  const depth={};
  g.nodes.forEach(n=>{depth[n.id]=0});
  for(let pass=0;pass<g.nodes.length;pass++)
    g.edges.forEach(([a,b])=>{depth[b]=Math.max(depth[b],depth[a]+1)});
  const cols={};
  g.nodes.forEach(n=>{(cols[depth[n.id]]=cols[depth[n.id]]||[]).push(n)});
  const BW=150,BH=30,GX=40,GY=12,pos={};
  let maxRow=1,maxCol=0;
  Object.entries(cols).forEach(([d,ns])=>{
    maxRow=Math.max(maxRow,ns.length); maxCol=Math.max(maxCol,+d);
    ns.forEach((n,i)=>{pos[n.id]=[8+d*(BW+GX), 8+i*(BH+GY)]});
  });
  const H=16+maxRow*(BH+GY), W=16+(maxCol+1)*(BW+GX);
  let out='';
  g.edges.forEach(([a,b])=>{
    const [x1,y1]=pos[a],[x2,y2]=pos[b];
    out+=`<line x1="${x1+BW}" y1="${y1+BH/2}" x2="${x2}" y2="${y2+BH/2}"
      stroke="#999" marker-end="url(#arr)"/>`;
  });
  g.nodes.forEach(n=>{
    const [x,y]=pos[n.id];
    const c=n.kind==='input'?'#e8f0d8':'#dce8f8';
    out+=`<rect x="${x}" y="${y}" width="${BW}" height="${BH}" rx="4"
      fill="${c}" stroke="#667"/>
      <text x="${x+6}" y="${y+19}" font-size="10">${n.label}</text>`;
  });
  // viewBox + height so deep DAGs (ResNet-50 ~50 columns) scale to the
  // card width instead of clipping at it
  el.setAttribute('height',H);
  el.setAttribute('viewBox',`0 0 ${W} ${H}`);
  el.setAttribute('preserveAspectRatio','xMinYMin meet');
  el.innerHTML='<defs><marker id="arr" markerWidth="8" markerHeight="8" '+
    'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" '+
    'fill="#999"/></marker></defs>'+out;
}
function actGrid(a){
  const el=document.getElementById('acts');
  if(!a.maps){el.innerHTML='(no activation records — attach a '+
    'ConvolutionalIterationListener)'; return;}
  el.innerHTML=`layer ${a.layer} @ iteration ${a.iteration}, `+
    `shape ${a.shape.join('x')}<br>`;
  a.maps.forEach(m=>{
    const h=m.length,w=m[0].length,cell=Math.max(1,Math.floor(64/w));
    const cv=document.createElement('canvas');
    cv.width=w*cell; cv.height=h*cell; cv.style.margin='2px';
    const ctx=cv.getContext('2d');
    m.forEach((row,y)=>row.forEach((v,x)=>{
      const g=Math.round(v*255);
      ctx.fillStyle=`rgb(${g},${g},${g})`;
      ctx.fillRect(x*cell,y*cell,cell,cell);
    }));
    el.appendChild(cv);
  });
}
function tsneChart(t){
  const el=document.getElementById('tsne'); el.innerHTML='';
  if(!t.coords||!t.coords.length) return;
  const W=900,H=420,P=20;
  const xs=t.coords.map(c=>c[0]),ys=t.coords.map(c=>c[1]);
  const xmin=Math.min(...xs),xmax=Math.max(...xs);
  const ymin=Math.min(...ys),ymax=Math.max(...ys);
  const sx=x=>P+(x-xmin)/(xmax-xmin||1)*(W-2*P);
  const sy=y=>H-P-(y-ymin)/(ymax-ymin||1)*(H-2*P);
  const colors=['#1565c0','#e65100','#2e7d32','#c62828','#6a1b9a',
                '#00838f','#f9a825','#4e342e'];
  let labelIdx={},next=0,out='';
  t.coords.forEach((c,i)=>{
    let col='#1565c0';
    if(t.labels){
      const l=t.labels[i];
      if(!(l in labelIdx)) labelIdx[l]=next++;
      col=colors[labelIdx[l]%colors.length];
    }
    out+=`<circle cx="${sx(c[0])}" cy="${sy(c[1])}" r="2.5"
      fill="${col}" fill-opacity="0.7"/>`;
  });
  el.innerHTML=out;
}
async function init(){
  const sessions=await j('/api/sessions');
  const sel=document.getElementById('sid');
  sel.innerHTML=sessions.map(s=>`<option>${s}</option>`).join('');
  sel.onchange=refresh; refresh(); setInterval(refresh, 3000);
}
init();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    storage: StatsStorage = None
    registry: Optional[_metrics.MetricsRegistry] = None

    def log_message(self, *args):  # silence request logging
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # header in → header out: the caller's trace context (or the
        # ui.request span opened under it) rides the response back
        tp = getattr(self, "_traceparent_out", None) \
            or self.headers.get("traceparent")
        if tp:
            self.send_header("traceparent", tp)
        self.end_headers()
        self.wfile.write(body)

    def _traced(self, method):
        """Dashboard requests carrying a ``traceparent`` header join the
        caller's trace: one ``ui.request`` span in the process-default
        tracer, its context echoed in the response header."""
        ctx = _tracing.extract(self.headers.get("traceparent"))
        if ctx is None:
            self._traceparent_out = None
            return method()
        with _tracing.TRACER.span(
                "ui.request", parent=ctx,
                attributes={"path": urlparse(self.path).path}) as span:
            self._traceparent_out = _tracing.inject(span)
            return method()

    def do_GET(self):
        return self._traced(self._handle_get)

    def _handle_get(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        st = self.storage
        if url.path == "/":
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif url.path == "/metrics":
            # Prometheus exposition: the dashboard process's registry
            # (training listeners, storage routing, phase timings)
            _metrics.write_exposition(self, self.registry
                                      or _metrics.REGISTRY)
        elif url.path == "/debug/flightrecorder":
            from ..util import flightrecorder as _flight
            self._json({"events": _flight.jsonable_events()})
        elif url.path == "/debug/timeline":
            from ..util import timeline as _timeline
            tid = q.get("trace_id", [None])[0]
            payload = {"traces": _timeline.trace_summaries(
                _tracing.TRACER, trace_id=tid)}
            self._json(json.loads(json.dumps(payload, default=repr)))
        elif url.path == "/debug/health":
            # training-health telemetry: latest rule report + stats
            # snapshot + NaN layer-of-origin attribution (util.health)
            from ..util import health as _health
            self._json(json.loads(
                json.dumps(_health.debug_payload(), default=repr)))
        elif url.path == "/api/sessions":
            self._json(st.list_session_ids())
        elif url.path == "/api/overview":
            sid = q.get("sid", [""])[0]
            iters, scores, timings = [], [], []
            for wid in st.list_workers(sid, "StatsListener"):
                for rec in st.get_all_updates_after(sid, "StatsListener",
                                                    wid, 0.0):
                    iters.append(rec.data.get("iteration"))
                    scores.append(rec.data.get("score"))
                    timings.append(rec.data.get("iteration_ms") or 0.0)
            self._json({"iterations": iters, "scores": scores,
                        "timings": timings})
        elif url.path == "/api/static":
            sid = q.get("sid", [""])[0]
            out = {}
            for wid in st.list_workers(sid, "StatsListener"):
                rec = st.get_static_info(sid, "StatsListener", wid)
                if rec:
                    out[wid] = {k: v for k, v in rec.data.items()
                                if k != "config_json"}
            self._json(out)
        elif url.path == "/api/flow":
            # network topology from the posted config JSON (parity:
            # FlowListenerModule — live network-flow diagram)
            sid = q.get("sid", [""])[0]
            self._json(self._flow_graph(sid))
        elif url.path == "/api/activations":
            # latest conv activation grid (parity:
            # ConvolutionalListenerModule)
            sid = q.get("sid", [""])[0]
            from .listeners import ACTIVATIONS_TYPE_ID
            latest = {}
            for wid in st.list_workers(sid, ACTIVATIONS_TYPE_ID):
                for rec in st.get_all_updates_after(
                        sid, ACTIVATIONS_TYPE_ID, wid, 0.0):
                    it = rec.data.get("iteration", -1)
                    if it >= latest.get("iteration", -1):
                        latest = rec.data
            self._json(latest)
        elif url.path == "/api/tsne":
            # stored t-SNE embeddings (parity: TsneModule)
            sid = q.get("sid", [""])[0]
            latest = {}
            for wid in st.list_workers(sid, "TsneModule"):
                for rec in st.get_all_updates_after(sid, "TsneModule",
                                                    wid, 0.0):
                    if rec.timestamp >= latest.get("timestamp", -1):
                        latest = {"timestamp": rec.timestamp, **rec.data}
            self._json(latest)
        elif url.path == "/api/histograms":
            # latest param histograms + per-param norm time series
            # (parity: the reference HistogramModule's data feed)
            sid = q.get("sid", [""])[0]
            workers = st.list_workers(sid, "StatsListener")
            latest, norms = {}, {}
            for wid in workers:
                for rec in st.get_all_updates_after(sid, "StatsListener",
                                                    wid, 0.0):
                    params = rec.data.get("parameters")
                    if not params:
                        continue
                    it = rec.data.get("iteration")
                    # newest snapshot across ALL workers, by iteration —
                    # not whichever worker happens to iterate last
                    if it is not None and it >= latest.get("iteration", -1):
                        latest = {"iteration": it, "worker": wid,
                                  "parameters": params}
                    for pname, entry in params.items():
                        # one series per (param, worker) so multi-worker
                        # sessions don't interleave into a zig-zag
                        key = (pname if len(workers) == 1
                               else f"{pname} [{wid}]")
                        s = norms.setdefault(key, {"iterations": [],
                                                   "norms": [],
                                                   "update_ratios": []})
                        s["iterations"].append(it)
                        s["norms"].append(entry.get("norm"))
                        s["update_ratios"].append(entry.get("update_ratio"))
            self._json({"latest": latest, "norm_series": norms})
        else:
            self._json({"error": "not found"}, 404)

    def _flow_graph(self, sid: str):
        """Nodes + edges parsed from the session's static config_json."""
        st = self.storage
        for wid in st.list_workers(sid, "StatsListener"):
            rec = st.get_static_info(sid, "StatsListener", wid)
            if not rec or "config_json" not in rec.data:
                continue
            conf = json.loads(rec.data["config_json"])
            nodes, edges = [], []
            if "vertices" in conf:  # ComputationGraph DAG
                for name in conf.get("network_inputs", []):
                    nodes.append({"id": name, "label": name, "kind": "input"})
                for name, v in conf["vertices"].items():
                    layer = (v.get("layer") or {}).get("__layer__") or {}
                    kind = layer.get("type") or v.get("type", "vertex")
                    nodes.append({"id": name, "label": f"{name} ({kind})",
                                  "kind": kind})
                for dst, srcs in conf.get("vertex_inputs", {}).items():
                    for s in srcs:
                        edges.append([s, dst])
            else:  # MultiLayerNetwork chain
                nodes.append({"id": "input", "label": "input",
                              "kind": "input"})
                prev = "input"
                for i, layer in enumerate(conf.get("layers", [])):
                    nid = layer.get("name") or f"layer_{i}"
                    nodes.append({"id": nid,
                                  "label": f"{nid} ({layer.get('type')})",
                                  "kind": layer.get("type", "layer")})
                    edges.append([prev, nid])
                    prev = nid
            return {"nodes": nodes, "edges": edges}
        return {"nodes": [], "edges": []}

    def do_POST(self):
        return self._traced(self._handle_post)

    def _handle_post(self):
        url = urlparse(self.path)
        if url.path == "/profile":
            # same contract as the inference server's /profile (one
            # capture at a time, process-wide)
            from ..util.profiling import profile_request
            body, code = profile_request(parse_qs(url.query))
            self._json(body, code)
            return
        if url.path == "/api/tsne":
            # upload coordinates, or raw vectors to embed server-side
            # (parity: TsneModule's coordinate-file upload)
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length).decode())
                sid = payload.get("sid", "default")
                labels = payload.get("labels")
                if "coords" in payload:
                    coords = payload["coords"]
                else:
                    from ..plot.tsne import BarnesHutTsne
                    import numpy as np
                    vecs = np.asarray(payload["vectors"], dtype=np.float64)
                    ts = BarnesHutTsne(
                        n_components=2,
                        perplexity=float(payload.get("perplexity", 30.0)),
                        max_iter=int(payload.get("iterations", 250)),
                        seed=int(payload.get("seed", 0)),
                        device=self.device)
                    coords = np.round(ts.fit_transform(vecs), 4).tolist()
                from ..storage.stats_storage import Persistable
                import time as _time
                self.storage.put_update(Persistable(
                    session_id=sid, type_id="TsneModule",
                    worker_id="upload", timestamp=_time.time(),
                    data={"coords": coords, "labels": labels}))
                self._json({"ok": True, "n": len(coords)})
            except Exception as e:
                self._json({"error": str(e)}, 400)
            return
        if url.path != "/api/remote":
            self._json({"error": "not found"}, 404)
            return
        # receiver for RemoteUIStatsStorageRouter (parity:
        # RemoteReceiverModule) — remote/distributed runs report into the
        # attached storage exactly like local listeners
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length).decode())
            from ..storage.stats_storage import Persistable
            rec = Persistable.from_json(json.dumps(payload["record"]))
            if payload.get("kind") == "static":
                self.storage.put_static_info(rec)
            else:
                self.storage.put_update(rec)
            self._json({"ok": True})
        except Exception as e:  # malformed POSTs must not kill the server
            self._json({"error": str(e)}, 400)


class UIServer:
    """``UIServer.get_instance().attach(storage)`` then browse
    ``http://localhost:<port>`` (parity: ``api/UIServer.java``).

    ``device`` is where ``POST /api/tsne`` embeds raw vectors with t-SNE
    (``"cuda"`` unless the caller passes ``"cpu"``); it is resolved only
    when such a request comes."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 device="cuda"):
        self.port = port
        self.device = device
        # default: the process registry, so a dashboard scrape sees the
        # training process's MetricsListener / storage-routing counters
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        from .stats import register_device_memory_gauges
        register_device_memory_gauges(self.registry)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.storage: Optional[StatsStorage] = None

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    def attach(self, storage: StatsStorage) -> "UIServer":
        self.storage = storage
        if self._httpd is None:
            handler = type("BoundHandler", (_Handler,),
                           {"storage": storage, "registry": self.registry,
                            "device": self.device})
            self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.RequestHandlerClass.storage = storage
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        UIServer._instance = None
