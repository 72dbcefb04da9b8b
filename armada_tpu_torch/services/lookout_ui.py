"""The Lookout single-page UI (served by lookout_http).

The reference ships a React/MUI app (internal/lookoutui/src: jobs table
with a filter/sort/group toolbar, job details sidebar with runs and
error/debug drilldown, job-sets view, and per-queue oversight). This is
the same surface as one dependency-free page: four views (Jobs, Groups,
Queues, Report) over the JSON API, with a server-side filter builder,
column sorting, pagination, grouping with aggregates, a job-details
drawer with per-run drilldowns, and a fair-share view per pool.
"""

UI_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>armada-tpu lookout</title>
<style>
:root{--bg:#f6f7f9;--fg:#1a1d21;--mut:#475467;--line:#eaecf0;--card:#fff;
--hdr:#101828;--acc:#175cd3}
body{font-family:system-ui,sans-serif;margin:0;background:var(--bg);color:var(--fg)}
header{background:var(--hdr);color:#fff;padding:10px 20px;display:flex;gap:18px;
align-items:center}
header h1{font-size:16px;margin:0}header .sub{color:#98a2b3;font-size:12px}
nav{display:flex;gap:4px;margin-left:24px}
nav button{background:none;border:none;color:#98a2b3;padding:6px 12px;font-size:13px;
cursor:pointer;border-radius:6px}
nav button.on{background:#1d2939;color:#fff}
main{padding:16px 20px;max-width:1280px;margin:auto}
.controls{display:flex;gap:8px;margin-bottom:10px;flex-wrap:wrap;align-items:center}
input,select,button{padding:6px 8px;border:1px solid #d0d5dd;border-radius:6px;
font-size:13px;background:#fff}
button.pri{background:var(--hdr);color:#fff;cursor:pointer;border-color:var(--hdr)}
button.lnk{border:none;background:none;color:var(--acc);cursor:pointer;padding:2px 4px}
.chip{display:inline-flex;gap:6px;align-items:center;background:#eef2f6;
border-radius:12px;padding:3px 10px;font-size:12px}
.chip b{font-weight:600}.chip span{cursor:pointer;color:#667085}
table{width:100%;border-collapse:collapse;background:var(--card);border-radius:8px;
overflow:hidden;box-shadow:0 1px 2px rgba(0,0,0,.06);font-size:13px}
th,td{padding:7px 10px;text-align:left;border-bottom:1px solid var(--line);
white-space:nowrap;overflow:hidden;text-overflow:ellipsis;max-width:220px}
th{background:#f9fafb;font-weight:600;font-size:12px;color:var(--mut);cursor:pointer;
user-select:none}
th .dir{color:var(--acc)}
tr.row:hover{background:#f4f7fb;cursor:pointer}
.state{padding:2px 8px;border-radius:10px;font-size:11px;font-weight:600}
.state.queued{background:#eff8ff;color:#175cd3}.state.running{background:#ecfdf3;color:#067647}
.state.leased,.state.pending{background:#fffaeb;color:#b54708}
.state.succeeded{background:#f0fdf4;color:#15803d}
.state.failed,.state.preempted{background:#fef3f2;color:#b42318}
.state.cancelled{background:#f2f4f7;color:#475467}
.cards{display:flex;gap:12px;margin-bottom:14px;flex-wrap:wrap}
.card{background:var(--card);border-radius:8px;padding:10px 16px;
box-shadow:0 1px 2px rgba(0,0,0,.06);cursor:pointer;min-width:84px}
.card b{display:block;font-size:20px}.card span{font-size:12px;color:var(--mut)}
.card.on{outline:2px solid var(--acc)}
pre{background:var(--card);padding:12px;border-radius:8px;font-size:12px;overflow:auto}
#drawer{position:fixed;top:0;right:-560px;width:540px;height:100%;background:#fff;
box-shadow:-6px 0 30px rgba(0,0,0,.18);transition:right .15s;z-index:20;
overflow:auto;padding:16px}
#drawer.open{right:0}
#drawer h2{font-size:15px;margin:4px 0 10px}
#drawer table{box-shadow:none}
.kv{display:grid;grid-template-columns:140px 1fr;gap:4px 10px;font-size:13px;
margin-bottom:10px}
.kv div:nth-child(odd){color:var(--mut)}
.bar{height:8px;border-radius:4px;background:#e4e7ec;position:relative;min-width:120px}
.bar i{position:absolute;left:0;top:0;bottom:0;border-radius:4px;background:#84caff}
.bar i.actual{background:var(--acc);opacity:.85}
.pager{display:flex;gap:8px;align-items:center;margin-top:10px;font-size:13px;
color:var(--mut)}
.err{color:#b42318;font-size:13px;margin:8px 0}
</style></head><body>
<header><h1>armada-tpu</h1><span class="sub">lookout</span>
<nav>
<button id="tab-jobs" class="on" onclick="show('jobs')">Jobs</button>
<button id="tab-groups" onclick="show('groups')">Groups</button>
<button id="tab-jobsets" onclick="show('jobsets')">Job Sets</button>
<button id="tab-errors" onclick="show('errors')">Errors</button>
<button id="tab-queues" onclick="show('queues')">Queues</button>
<button id="tab-report" onclick="show('report')">Report</button>
</nav>
<span style="flex:1"></span>
<label style="color:#98a2b3;font-size:12px"><input type="checkbox" id="auto" checked>
auto-refresh</label>
</header>
<main>
<div id="v-jobs">
  <div class="cards" id="cards"></div>
  <div class="controls">
    <select id="f-field"><option>queue</option><option>jobset</option>
      <option>job_id</option><option>state</option><option>priority_class</option>
      <option>node</option><option>executor</option><option>error_category</option>
      <option value="__ann__">annotation…</option></select>
    <input id="f-ann" placeholder="annotation key" style="display:none;width:120px">
    <select id="f-match"><option>exact</option><option>startsWith</option>
      <option>contains</option><option>anyOf</option><option>exists</option>
      <option>greaterThan</option><option>lessThan</option></select>
    <input id="f-value" placeholder="value">
    <button class="pri" onclick="addFilter()">add filter</button>
    <span id="chips"></span>
  </div>
  <div class="err" id="jobs-err" style="display:none"></div>
  <table id="jobs"><thead><tr>
    <th data-col="job_id">job</th><th data-col="queue">queue</th>
    <th data-col="jobset">jobset</th><th data-col="state">state</th>
    <th data-col="priority">prio</th><th data-col="node">node</th>
    <th data-col="executor">executor</th><th data-col="attempts">att</th>
    <th data-col="submitted">submitted</th><th data-col="error_category">error</th>
  </tr></thead><tbody></tbody></table>
  <div class="pager">
    <button onclick="page(-1)">&#8592; prev</button>
    <span id="pageinfo"></span>
    <button onclick="page(1)">next &#8594;</button>
    <select id="take" onchange="st.skip=0;load()">
      <option>25</option><option selected>50</option><option>100</option>
      <option>200</option></select>
  </div>
</div>
<div id="v-groups" style="display:none">
  <div class="controls">
    group by
    <select id="g-by"><option>queue</option><option>jobset</option>
      <option>state</option><option>priority_class</option>
      <option>error_category</option><option value="__ann__">annotation…</option>
    </select>
    <input id="g-ann" placeholder="annotation key" style="display:none;width:120px">
    <label><input type="checkbox" id="g-states" checked> state counts</label>
    <label><input type="checkbox" id="g-sub"> submitted min/max</label>
    <label><input type="checkbox" id="g-rt"> runtime avg</label>
    <button class="pri" onclick="loadGroups()">group</button>
  </div>
  <table id="groups"><thead></thead><tbody></tbody></table>
</div>
<div id="v-jobsets" style="display:none">
  <div class="controls">
    queue <input id="js-queue" placeholder="(all queues)" style="width:160px">
    <button class="pri" onclick="loadJobsets()">refresh</button>
  </div>
  <table id="jobsets"><thead><tr><th>queue</th><th>jobset</th><th>jobs</th>
    <th>states</th><th>first submit</th><th>last submit</th><th></th>
  </tr></thead><tbody></tbody></table>
</div>
<div id="v-errors" style="display:none">
  <div class="err" id="errors-err" style="display:none"></div>
  <table id="errors"><thead><tr><th>job</th><th>queue</th><th>jobset</th>
    <th>category</th><th>error</th></tr></thead><tbody></tbody></table>
</div>
<div id="v-queues">
  <div id="fairshare"></div>
</div>
<div id="v-report" style="display:none">
  <pre id="report"></pre>
  <pre id="prices" style="display:none"></pre>
</div>
</main>
<div id="drawer">
  <button style="float:right" onclick="closeDrawer()">close</button>
  <h2 id="d-title"></h2>
  <div id="d-actions" style="margin-bottom:8px"></div>
  <div class="kv" id="d-kv"></div>
  <h2>runs</h2>
  <table id="d-runs"><thead><tr><th>run</th><th>node</th><th>state</th>
    <th>drill</th></tr></thead><tbody></tbody></table>
  <h2>spec</h2>
  <pre id="d-spec"></pre>
  <pre id="d-drill" style="display:none"></pre>
</div>
<script>
const st={view:'jobs',filters:[],order:'submitted',dir:'desc',skip:0,state:''};
async function jget(u){const r=await fetch(u);if(!r.ok)throw new Error(
  (await r.json().catch(()=>({}))).error||r.statusText);return r.json()}
function esc(x){return String(x??'').replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function show(v){st.view=v;
  for(const t of ['jobs','groups','jobsets','errors','queues','report']){
    document.getElementById('v-'+t).style.display=t===v?'':'none';
    document.getElementById('tab-'+t).classList.toggle('on',t===v)}
  refresh()}
document.getElementById('f-field').onchange=e=>{
  document.getElementById('f-ann').style.display=
    e.target.value==='__ann__'?'':'none'};
document.getElementById('g-by').onchange=e=>{
  document.getElementById('g-ann').style.display=
    e.target.value==='__ann__'?'':'none'};
function addFilter(){
  let field=document.getElementById('f-field').value,ann=false;
  if(field==='__ann__'){field=document.getElementById('f-ann').value;ann=true}
  const match=document.getElementById('f-match').value;
  let value=document.getElementById('f-value').value;
  if(match==='anyOf')value=value.split(',').map(s=>s.trim());
  if(match==='greaterThan'||match==='lessThan')value=parseFloat(value);
  if(!field)return;
  st.filters.push({field,value,match,isAnnotation:ann});st.skip=0;load()}
function delFilter(i){st.filters.splice(i,1);st.skip=0;load()}
function renderChips(){
  document.getElementById('chips').innerHTML=st.filters.map((f,i)=>
    `<span class="chip"><b>${esc(f.field)}</b> ${esc(f.match)}
     ${esc(Array.isArray(f.value)?f.value.join(','):f.value??'')}
     <span onclick="delFilter(${i})">&#10005;</span></span>`).join(' ')}
function filtersParam(){
  const fs=[...st.filters];
  if(st.state)fs.push({field:'state',value:st.state,match:'exact'});
  return fs.length?'&filters='+encodeURIComponent(JSON.stringify(fs)):''}
function sortBy(col){
  if(st.order===col)st.dir=st.dir==='asc'?'desc':'asc';
  else{st.order=col;st.dir='asc'}st.skip=0;load()}
document.querySelectorAll('#jobs th').forEach(th=>
  th.onclick=()=>sortBy(th.dataset.col));
function page(d){
  const take=+document.getElementById('take').value;
  st.skip=Math.max(0,st.skip+d*take);load()}
async function load(){
  renderChips();
  const take=+document.getElementById('take').value;
  const err=document.getElementById('jobs-err');err.style.display='none';
  try{
    const groups=await jget('/api/groups?by=state'+filtersParamNoState());
    const total=groups.groups.reduce((a,g)=>a+g.count,0);
    const cards=document.getElementById('cards');
    cards.innerHTML=
      `<div class="card ${st.state?'':'on'}" data-state="">
       <b>${total}</b><span>all</span></div>`+
      groups.groups.map(g=>
      `<div class="card ${st.state===g.name?'on':''}" data-state="${esc(g.name)}">
       <b>${g.count}</b><span>${esc(g.name)}</span></div>`).join('');
    cards.querySelectorAll('.card').forEach(c=>
      c.onclick=()=>{st.state=c.dataset.state;st.skip=0;load()});
    const u=`/api/jobs?take=${take}&skip=${st.skip}&order=${st.order}`+
      `&direction=${st.dir}`+filtersParam();
    const data=await jget(u);
    document.querySelector('#jobs tbody').innerHTML=data.jobs.map(j=>
      `<tr class="row">
       <td>${esc(j.job_id)}</td><td>${esc(j.queue)}</td><td>${esc(j.jobset)}</td>
       <td><span class="state ${esc(j.state)}">${esc(j.state)}</span></td>
       <td>${esc(j.priority)}</td><td>${esc(j.node)}</td>
       <td>${esc(j.executor)}</td><td>${esc(j.attempts)}</td>
       <td>${new Date(j.submitted*1000).toISOString().slice(0,19)}</td>
       <td title="${esc(j.error)}">${esc(j.error_category||(j.error?'error':''))}
       </td></tr>`).join('');
    document.querySelectorAll('#jobs tbody tr').forEach((tr,i)=>
      tr.onclick=()=>openJob(data.jobs[i].job_id));
    document.getElementById('pageinfo').textContent=
      `${st.skip+1}-${Math.min(st.skip+take,data.total)} of ${data.total}`;
  }catch(e){err.textContent=e.message;err.style.display=''}
}
function filtersParamNoState(){
  return st.filters.length?
    '&filters='+encodeURIComponent(JSON.stringify(st.filters)):''}
async function loadGroups(){
  let by=document.getElementById('g-by').value,ann=false;
  if(by==='__ann__'){by=document.getElementById('g-ann').value;ann=true}
  const aggs=[];
  if(document.getElementById('g-sub').checked)
    aggs.push({field:'submitted',type:'min'},{field:'submitted',type:'max'});
  if(document.getElementById('g-rt').checked)
    aggs.push({field:'runtime_s',type:'average'});
  if(document.getElementById('g-states').checked)aggs.push('state_counts');
  const u=`/api/groups?by=${encodeURIComponent(by)}`+(ann?'&byAnnotation=1':'')+
    `&aggregates=${encodeURIComponent(JSON.stringify(aggs))}`+
    filtersParamNoState();
  const data=await jget(u);
  const cols=new Set();
  data.groups.forEach(g=>Object.keys(g.aggregates).forEach(k=>cols.add(k)));
  const cl=[...cols];
  document.querySelector('#groups thead').innerHTML=
    '<tr><th>'+esc(by)+'</th><th>count</th>'+
    cl.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>';
  document.querySelector('#groups tbody').innerHTML=data.groups.map(g=>
    `<tr class="row">
     <td>${esc(g.name)}</td><td>${g.count}</td>`+
    cl.map(c=>{let v=g.aggregates[c];
      if(typeof v==='object'&&v)v=Object.entries(v).map(
        ([k,n])=>`${k}:${n}`).join(' ');
      if(typeof v==='number'&&!Number.isInteger(v))v=v.toFixed(2);
      return '<td>'+esc(v??'')+'</td>'}).join('')+'</tr>').join('');
  document.querySelectorAll('#groups tbody tr').forEach((tr,i)=>
    tr.onclick=()=>drillGroup(by,data.groups[i].name,ann));
}
function drillGroup(field,value,ann){
  st.filters=[{field,value,match:'exact',isAnnotation:!!ann}];st.skip=0;
  show('jobs')}
async function loadQueues(){
  const data=await jget('/api/fairshare');
  let html='';
  for(const pool in data.pools){
    const rows=data.pools[pool];
    html+=`<h3 style="margin:6px 0">pool: ${esc(pool)}</h3>
    <table><thead><tr><th>queue</th><th>fair share</th><th>adjusted</th>
    <th>actual</th><th>share</th><th>scheduled</th><th>preempted</th>
    <th>top reasons</th></tr></thead><tbody>`+
    rows.map(r=>{
      const fs=(r.adjusted_fair_share*100),ac=(r.actual_share*100);
      return `<tr><td>${esc(r.queue)}</td>
      <td>${(r.fair_share*100).toFixed(1)}%</td>
      <td>${fs.toFixed(1)}%</td><td>${ac.toFixed(1)}%</td>
      <td><div class="bar"><i style="width:${Math.min(100,fs)}%"></i>
      <i class="actual" style="width:${Math.min(100,ac)}%"></i></div></td>
      <td>${r.scheduled_jobs}</td><td>${r.preempted_jobs}</td>
      <td>${esc(Object.entries(r.top_reasons||{}).slice(0,3)
        .map(([k,v])=>`${k} (${v})`).join('; '))}</td></tr>`}).join('')+
    '</tbody></table>';
  }
  document.getElementById('fairshare').innerHTML=
    html||'<p style="color:#475467">no scheduling rounds yet</p>';
}
async function loadReport(){
  document.getElementById('report').textContent=
    (await jget('/api/report')).report||'no report yet';
  try{
    const p=await jget('/api/prices');
    if(Object.keys(p).length){
      const el=document.getElementById('prices');
      el.textContent='market prices\n'+JSON.stringify(p,null,2);
      el.style.display=''}
  }catch(e){}
}
async function openJob(id){
  const d=await jget('/api/details/'+encodeURIComponent(id));
  document.getElementById('d-title').textContent=d.job_id;
  const kv=[['queue',d.queue],['jobset',d.jobset],['state',d.state],
    ['priority',d.priority],['priority class',d.priority_class],
    ['submitted',new Date(d.submitted*1000).toISOString()],
    ['error',d.error||''],['error category',d.error_category||'']];
  document.getElementById('d-kv').innerHTML=
    kv.map(([k,v])=>`<div>${esc(k)}</div><div>${esc(v)}</div>`).join('');
  document.querySelector('#d-runs tbody').innerHTML=(d.runs||[]).map(r=>
    `<tr><td title="${esc(r.run_id)}">${esc(r.run_id.slice(0,13))}</td>
     <td>${esc(r.node)}</td>
     <td><span class="state ${esc(r.state)}">${esc(r.state)}</span></td>
     <td><button class="lnk" data-k="error">err</button>
     <button class="lnk" data-k="debug">debug</button>
     <button class="lnk" data-k="termination">term</button>
     </td></tr>`).join('');
  document.querySelectorAll('#d-runs tbody tr').forEach((tr,i)=>
    tr.querySelectorAll('button').forEach(b=>
      b.onclick=()=>drillRun(d.runs[i].run_id,b.dataset.k)));
  document.getElementById('d-spec').textContent=
    JSON.stringify({requests:d.requests,annotations:d.annotations},null,2);
  document.getElementById('d-drill').style.display='none';
  const act=document.getElementById('d-actions');act.innerHTML='';
  {const l=document.createElement('button');l.textContent='logs';
   l.onclick=async()=>{const el=document.getElementById('d-drill');
     try{const data=await jget('/api/logs/'+encodeURIComponent(d.job_id)+
       '?tail=200');
       el.textContent='logs for '+d.job_id+'\n\n'+
         ((data.lines||[]).join('\n')||'(empty)');}
     catch(e){el.textContent='logs: '+e.message}
     el.style.display=''};
   act.append(l,' ');}
  if(['queued','leased','pending','running'].includes(d.state)){
    const c=document.createElement('button');c.className='pri';
    c.textContent='cancel';
    c.onclick=()=>cancelJob(d.queue,d.jobset,d.job_id);
    const r=document.createElement('button');r.textContent='reprioritize';
    r.onclick=()=>reprioritizeJob(d.queue,d.jobset,d.job_id);
    act.append(c,' ',r);
  }
  document.getElementById('drawer').classList.add('open');
}
async function drillRun(runId,kind){
  const d=await jget(`/api/runs/${encodeURIComponent(runId)}/${kind}`);
  const el=document.getElementById('d-drill');
  el.textContent=`${kind} for ${runId}\n\n`+(d.message||'(empty)');
  el.style.display='';
}
function closeDrawer(){document.getElementById('drawer').classList.remove('open')}
async function post(u,body){const r=await fetch(u,{method:'POST',
  headers:{'Content-Type':'application/json',
           'X-Requested-With':'armada-lookout'},body:JSON.stringify(body)});
  const d=await r.json().catch(()=>({}));
  if(!r.ok)throw new Error(d.error||r.statusText);return d}
async function cancelJob(queue,jobset,id){
  if(!confirm(`cancel ${id}?`))return;
  try{await post('/api/cancel',{queue,jobset,job_ids:[id]});closeDrawer();load()}
  catch(e){alert(e.message)}}
async function reprioritizeJob(queue,jobset,id){
  const p=prompt('new priority (lower schedules first)');if(p===null)return;
  try{await post('/api/reprioritize',{queue,jobset,job_ids:[id],priority:+p});
    closeDrawer();load()}catch(e){alert(e.message)}}
async function cancelJobset(queue,jobset){
  if(!confirm(`cancel every active job in ${queue}/${jobset}?`))return;
  try{await post('/api/cancel',{queue,jobset});loadJobsets()}
  catch(e){alert(e.message)}}
async function loadJobsets(){
  // Group per (queue, jobset): same-named jobsets in different queues
  // must stay separate rows (and cancel the right queue).
  const filter=document.getElementById('js-queue').value.trim();
  let queues=filter?[filter]:
    (await jget('/api/queues')).queues.map(x=>x.name);
  const aggs=encodeURIComponent(JSON.stringify(
    ['state_counts',{field:'submitted',type:'min'},{field:'submitted',type:'max'}]));
  const rows=[];
  for(const queue of queues){
    const fs=encodeURIComponent(JSON.stringify(
      [{field:'queue',value:queue,match:'exact'}]));
    const data=await jget(`/api/groups?by=jobset&aggregates=${aggs}&filters=${fs}`);
    for(const g of data.groups)rows.push({queue,g});
  }
  const fmt=t=>t?new Date(t*1000).toISOString().slice(0,19):'';
  document.querySelector('#jobsets tbody').innerHTML=rows.map(({queue,g})=>{
    const sc=g.aggregates.state_counts||{};
    const states=Object.entries(sc).map(([k,n])=>
      `<span class="state ${esc(k)}">${esc(k)} ${n}</span>`).join(' ');
    return `<tr><td>${esc(queue)}</td>
      <td>${esc(g.name)}</td><td>${g.count}</td><td>${states}</td>
      <td>${fmt(g.aggregates.submitted_min)}</td>
      <td>${fmt(g.aggregates.submitted_max)}</td>
      <td><button class="lnk">cancel</button></td></tr>`}).join('')||
    '<tr><td colspan="7">no jobsets</td></tr>';
  document.querySelectorAll('#jobsets tbody button').forEach((b,i)=>
    b.onclick=()=>cancelJobset(rows[i].queue,rows[i].g.name));
}
async function loadErrors(){
  const err=document.getElementById('errors-err');err.style.display='none';
  try{
    const data=await jget('/api/errors');
    document.querySelector('#errors tbody').innerHTML=(data.errors||[]).map(e=>
      `<tr class="row">
       <td>${esc(e.job_id)}</td><td>${esc(e.queue)}</td><td>${esc(e.jobset)}</td>
       <td>${esc(e.error_category||'')}</td>
       <td title="${esc(e.error)}">${esc((e.error||'').slice(0,160))}</td>
       </tr>`).join('')||'<tr><td colspan="5">no failed jobs</td></tr>';
    document.querySelectorAll('#errors tbody tr.row').forEach((tr,i)=>
      tr.onclick=()=>openJob(data.errors[i].job_id));
  }catch(e){err.textContent=e.message;err.style.display=''}
}
function refresh(){
  if(st.view==='jobs')load();
  else if(st.view==='groups')loadGroups();
  else if(st.view==='jobsets')loadJobsets();
  else if(st.view==='errors')loadErrors();
  else if(st.view==='queues')loadQueues();
  else loadReport()}
setInterval(()=>{if(document.getElementById('auto').checked&&
  !document.getElementById('drawer').classList.contains('open'))refresh()},3000);
show('jobs');
</script></body></html>
"""
