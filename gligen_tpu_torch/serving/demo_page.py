"""Browser demo page (reference demo/app.py's Gradio sketchpad, as a
dependency-free static page served by the HTTP API): the port's own copy
of ``gligen_tpu/serving/demo_page.py``, served by ``serving/server.py``.

Drag on the canvas to draw grounding boxes, attach a phrase to each, and
POST to /generate; results render alongside the layout.
"""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>gligen_tpu_torch demo</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; background: #111; color: #eee; }
 #canvas { border: 1px solid #555; cursor: crosshair; background: #1b1b1b; touch-action: none; }
 .row { display: flex; gap: 2rem; align-items: flex-start; flex-wrap: wrap; }
 input, button, select { background: #222; color: #eee; border: 1px solid #555; padding: .45rem .6rem; border-radius: 4px; }
 button { cursor: pointer; }
 #phrases div { margin: .25rem 0; }
 #out img { width: 256px; margin: .3rem; border: 1px solid #444; }
 .hint { color: #888; font-size: .85rem; }
</style></head><body>
<h2>gligen_tpu_torch — grounded generation</h2>
<div class="row">
  <div>
    <canvas id="canvas" width="512" height="512"></canvas>
    <div class="hint">drag to draw a box; double-click to clear</div>
  </div>
  <div style="min-width: 22rem">
    <div><input id="prompt" size="44" placeholder="prompt, e.g. a teddy bear next to a bird"></div>
    <div id="phrases"></div>
    <div style="margin-top:.6rem">
      steps <input id="steps" value="50" size="3">
      scale <input id="scale" value="7.5" size="3">
      batch <input id="batch" value="1" size="2">
      seed <input id="seed" value="0" size="4">
    </div>
    <div style="margin-top:.6rem"><button id="go">generate</button> <span id="status"></span></div>
    <div id="out"></div>
  </div>
</div>
<script>
const cv = document.getElementById('canvas'), ctx = cv.getContext('2d');
let boxes = [], start = null, cur = null;
const colors = ['#e66', '#6e6', '#66e', '#ee6', '#e6e', '#6ee'];
function redraw() {
  ctx.clearRect(0, 0, 512, 512);
  boxes.forEach((b, i) => {
    ctx.strokeStyle = colors[i % colors.length]; ctx.lineWidth = 2;
    ctx.strokeRect(b[0]*512, b[1]*512, (b[2]-b[0])*512, (b[3]-b[1])*512);
  });
  if (start && cur) {
    ctx.strokeStyle = '#999';
    ctx.strokeRect(start[0], start[1], cur[0]-start[0], cur[1]-start[1]);
  }
}
function phraseInputs() {
  const holder = document.getElementById('phrases');
  holder.innerHTML = '';
  boxes.forEach((b, i) => {
    const div = document.createElement('div');
    div.innerHTML = `<span style="color:${colors[i % colors.length]}">box ${i+1}</span> `;
    const inp = document.createElement('input');
    inp.size = 30; inp.placeholder = 'phrase'; inp.id = 'ph' + i;
    inp.value = b.phrase || '';
    inp.oninput = () => { boxes[i].phrase = inp.value; };
    div.appendChild(inp);
    holder.appendChild(div);
  });
}
cv.onpointerdown = e => { start = [e.offsetX, e.offsetY]; };
cv.onpointermove = e => { if (start) { cur = [e.offsetX, e.offsetY]; redraw(); } };
cv.onpointerup = e => {
  if (!start) return;
  const b = [Math.min(start[0], e.offsetX)/512, Math.min(start[1], e.offsetY)/512,
             Math.max(start[0], e.offsetX)/512, Math.max(start[1], e.offsetY)/512];
  if ((b[2]-b[0]) > 0.02 && (b[3]-b[1]) > 0.02) { b.phrase = ''; boxes.push(b); }
  start = cur = null; redraw(); phraseInputs();
};
cv.ondblclick = () => { boxes = []; redraw(); phraseInputs(); };
document.getElementById('go').onclick = async () => {
  const status = document.getElementById('status');
  status.textContent = 'generating…';
  const body = {
    prompt: document.getElementById('prompt').value,
    phrases: boxes.map(b => b.phrase || ''),
    locations: boxes.map(b => [b[0], b[1], b[2], b[3]]),
    steps: +document.getElementById('steps').value,
    guidance_scale: +document.getElementById('scale').value,
    batch_size: +document.getElementById('batch').value,
    seed: +document.getElementById('seed').value,
  };
  try {
    const r = await fetch('/generate', {method: 'POST', body: JSON.stringify(body)});
    const out = await r.json();
    if (out.error) throw new Error(out.error);
    const holder = document.getElementById('out');
    holder.innerHTML = '';
    out.images.forEach(b64 => {
      const img = document.createElement('img');
      img.src = 'data:image/png;base64,' + b64;
      holder.appendChild(img);
    });
    status.textContent = `${out.latency_sec}s`;
  } catch (err) { status.textContent = 'error: ' + err.message; }
};
redraw();
</script></body></html>
"""
