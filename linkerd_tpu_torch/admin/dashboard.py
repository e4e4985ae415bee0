"""Admin dashboard: a self-contained HTML page at ``/``: a copy of
``linkerd_tpu/admin/dashboard.py``.

Ref: the reference's D3 dashboard (admin/src/main/resources/io/buoyant/
admin/js, 46 files) reimagined as one dependency-free page: live
request-rate sparklines + request/success/latency tiles per router
(polling /admin/metrics.json), service and client tables, live bound
names (/bound-names.json), per-dst anomaly scores (/anomaly.json), and
the dtab playground backed by /delegator.json.
"""

from __future__ import annotations

from linkerd_tpu_torch.protocol.http.message import Headers, Request, Response

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>linkerd-tpu admin</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f4f5f7;color:#1c2330}
 header{background:#0a295c;color:#fff;padding:12px 20px;font-size:18px}
 header span{opacity:.65;font-size:13px;margin-left:10px}
 header a{color:#9fc2ff;font-size:13px;margin-left:18px;text-decoration:none}
 main{padding:20px;max-width:1150px;margin:auto}
 .tiles{display:flex;gap:12px;flex-wrap:wrap;margin-bottom:18px}
 .tile{background:#fff;border-radius:8px;padding:12px 18px;min-width:150px;
       box-shadow:0 1px 3px rgba(0,0,0,.08)}
 .tile b{display:block;font-size:24px}
 .tile small{color:#667}
 table{border-collapse:collapse;width:100%;background:#fff;border-radius:8px;
       box-shadow:0 1px 3px rgba(0,0,0,.08);margin-bottom:18px}
 th,td{padding:8px 12px;text-align:left;border-bottom:1px solid #eef}
 th{background:#fafbfd;font-weight:600;font-size:13px;color:#456}
 h2{font-size:15px;color:#345;margin:18px 0 8px}
 input{padding:6px 10px;border:1px solid #ccd;border-radius:6px;width:320px}
 button{padding:6px 14px;border:0;border-radius:6px;background:#0a295c;
        color:#fff;cursor:pointer}
 pre{background:#0e1726;color:#cfe3ff;padding:12px;border-radius:8px;
     overflow:auto;font-size:12px}
 .ok{color:#0a7d38}.bad{color:#b3261e}.warn{color:#9a6b00}
 .bar{display:inline-block;height:10px;background:#dfe6f2;border-radius:3px;
      overflow:hidden;width:120px;vertical-align:middle}
 .bar i{display:block;height:100%;background:#b3261e}
 svg.spark{vertical-align:middle}
 svg.spark polyline{fill:none;stroke:#2f6fed;stroke-width:1.5}
</style></head><body>
<header>linkerd-tpu<span>service-mesh router &mdash; admin</span>
 <a href="/config.json">config</a>
 <a href="/admin/metrics.json">metrics</a>
 <a href="/admin/metrics/prometheus">prometheus</a>
 <a href="/admin/pprof/profile?seconds=3">profile</a>
</header>
<main>
 <div class="tiles" id="tiles"></div>
 <h2>routers</h2><table id="routers"><thead>
  <tr><th>router</th><th>rate</th><th>req/s</th><th>requests</th>
      <th>success %</th><th>failures</th><th>p50 ms</th><th>p99 ms</th>
  </tr></thead><tbody></tbody></table>
 <h2>services (logical names)</h2><table id="services"><thead>
  <tr><th>service</th><th>requests</th><th>retries</th>
      <th>anomaly score</th></tr></thead><tbody></tbody></table>
 <h2>clients (concrete destinations)</h2><table id="clients"><thead>
  <tr><th>client</th><th>requests</th><th>failures</th><th>endpoints</th>
  </tr></thead><tbody></tbody></table>
 <h2>bound names</h2><pre id="bound">&mdash;</pre>
 <h2>dtab playground</h2>
 <p><input id="dpath" placeholder="/svc/web" value="/svc/web">
    <button onclick="delegate()">delegate</button></p>
 <pre id="dout">&mdash;</pre>
</main>
<script>
function esc(s){return String(s).replace(/[&<>"']/g,
 c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
const hist = {};           // router -> [req counts] for sparkline/rate
const HIST_N = 60;         // 2 min at 2s polls
function spark(r){
 const h = hist[r]||[];
 if(h.length < 2) return '';
 const deltas = [];
 for(let i=1;i<h.length;i++) deltas.push(Math.max(0, h[i]-h[i-1]));
 const max = Math.max(1, ...deltas);
 const pts = deltas.map((d,i)=>
   `${(i/(HIST_N-2)*118+1).toFixed(1)},${(13-d/max*12).toFixed(1)}`);
 return `<svg class="spark" width="120" height="14">`+
        `<polyline points="${pts.join(' ')}"/></svg>`;
}
function rate(r){
 const h = hist[r]||[];
 if(h.length < 2) return '';
 return (Math.max(0, h[h.length-1]-h[h.length-2])/2).toFixed(1);
}
async function refresh(){
 try{
  const [m, anomaly, boundTxt] = await Promise.all([
   fetch('/admin/metrics.json').then(r=>r.json()),
   fetch('/anomaly.json').then(r=>r.json()).then(j=>j.scores||{})
     .catch(()=>({})),
   fetch('/bound-names.json').then(r=>r.json())
     .then(j=>JSON.stringify(j,null,2)).catch(()=>null),
  ]);
  if(boundTxt!=null)
   document.getElementById('bound').textContent = boundTxt;
  const routers={}, clients={}, services={};
  let total=0, fails=0;
  for(const [k,v] of Object.entries(m)){
   const parts = k.split('/');
   if(parts[0]!=='rt') continue;
   const rt = parts[1];
   if(parts[2]==='server'){
    routers[rt] = routers[rt]||{};
    if(parts[3]==='requests'){routers[rt].req=v; total+=v;}
    if(parts[3]==='success') routers[rt].ok=v;
    if(parts[3]==='failures'){routers[rt].fail=v; fails+=v;}
    if(parts[3]==='request_latency_ms'&&parts[4]==='p50')routers[rt].p50=v;
    if(parts[3]==='request_latency_ms'&&parts[4]==='p99')routers[rt].p99=v;
   }
   if(parts[2]==='service'){
    const s = rt+'/'+parts[3]; services[s]=services[s]||{};
    if(parts[4]==='requests') services[s].req=v;
    if(parts[4]==='retries'&&parts[5]==='total') services[s].retries=v;
   }
   if(parts[2]==='client'){
    const c = rt+'/'+parts[3]; clients[c]=clients[c]||{dst:parts[3]};
    if(parts[4]==='requests') clients[c].req=v;
    if(parts[4]==='failures') clients[c].fail=v;
    if(parts[4]==='endpoints') clients[c].eps=v;
   }
  }
  for(const [r,s] of Object.entries(routers)){
   hist[r] = (hist[r]||[]).concat([s.req||0]).slice(-HIST_N);
  }
  const nAnom = Object.values(anomaly).filter(s=>s>0.5).length;
  document.getElementById('tiles').innerHTML =
   tile(total,'total requests')+tile(fails,'failures',fails?'bad':'ok')+
   tile(Object.keys(routers).length,'routers')+
   tile(Object.keys(clients).length,'live clients')+
   tile(nAnom,'anomalous dsts', nAnom?'warn':'ok');
  // anomaly board keys are logical dst paths ('/svc/web'); service
  // rows use the same lstrip('/')+'.'-join normalization — exact join
  const anomalyByService = {};
  for(const [k,v] of Object.entries(anomaly))
   anomalyByService[(k.startsWith('/')?k.slice(1):k).replaceAll('/','.')] = v;
  document.querySelector('#routers tbody').innerHTML =
   Object.entries(routers).map(([r,s])=>{
    const pct = s.req ? (100*(s.ok||0)/s.req).toFixed(1) : '';
    return `<tr><td>${esc(r)}</td><td>${spark(r)}</td><td>${rate(r)}</td>`+
     `<td>${s.req||0}</td><td class="${pct<99?'warn':'ok'}">${pct}</td>`+
     `<td>${s.fail||0}</td><td>${fmt(s.p50)}</td><td>${fmt(s.p99)}</td></tr>`;
   }).join('');
  document.querySelector('#services tbody').innerHTML =
   Object.entries(services).map(([s,v])=>{
    const name = s.split('/').slice(1).join('/');
    return `<tr><td>${esc(s)}</td><td>${v.req||0}</td>`+
     `<td>${v.retries||0}</td>`+
     `<td>${scoreBar(anomalyByService[name])}</td></tr>`;
   }).join('');
  document.querySelector('#clients tbody').innerHTML =
   Object.entries(clients).map(([c,s])=>
    `<tr><td>${esc(c)}</td><td>${s.req||0}</td><td>${s.fail||0}</td>`+
    `<td>${s.eps??''}</td></tr>`).join('');
 }catch(e){ /* keep last view */ }
}
function scoreBar(v){
 if(v==null) return '';
 const pct = Math.min(100, v*100).toFixed(0);
 return `<span class="bar"><i style="width:${pct}%"></i></span> ${v.toFixed(3)}`;
}
function tile(v,label,cls){return `<div class="tile"><b class="${cls||''}">${v}</b><small>${label}</small></div>`}
function fmt(v){return v==null?'':(+v).toFixed(1)}
async function delegate(){
 const p = document.getElementById('dpath').value;
 const r = await fetch('/delegator.json?path='+encodeURIComponent(p));
 document.getElementById('dout').textContent =
   JSON.stringify(await r.json(), null, 2);
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


async def dashboard_handler(req: Request) -> Response:
    return Response(status=200,
                    headers=Headers([("Content-Type",
                                      "text/html; charset=utf-8")]),
                    body=_PAGE.encode())
