"""Browser demo page served at ``GET /demo``.

A copy of ``llmvox_tpu/serve/demo_page.py``: a page with no dependencies
that speaks the server's own wire format.  ``POST /tts`` streams raw
little-endian float32 PCM at 24 kHz over chunked transfer, and the page
plays it through WebAudio while the stream is still arriving.
"""

DEMO_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>LLMVoX-TPU demo</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 640px;
         margin: 3rem auto; padding: 0 1rem; color: #222; }
  textarea { width: 100%; height: 5rem; font-size: 1rem; padding: .5rem;
             box-sizing: border-box; }
  button { font-size: 1rem; padding: .5rem 1.5rem; margin-top: .5rem;
           cursor: pointer; }
  #status { margin-top: 1rem; font-variant-numeric: tabular-nums;
            white-space: pre-line; }
  .bar { height: 6px; background: #eee; margin-top: .5rem; }
  .bar > div { height: 100%; width: 0; background: #4a7; }
</style>
</head>
<body>
<h1>LLMVoX-TPU</h1>
<p>Streaming text-to-speech. Audio plays while the server is still
generating.</p>
<textarea id="text">Hello! This is streaming speech synthesis running on a TPU.</textarea>
<br>
<button id="go">Synthesize</button>
<div id="status">idle</div>
<div class="bar"><div id="fill"></div></div>
<script>
const SR = 24000;
const state = { firstChunkMs: null, audioSeconds: 0, done: false,
                error: null };
window.llmvoxState = state;

async function synthesize() {
  const status = document.getElementById('status');
  const fill = document.getElementById('fill');
  const text = document.getElementById('text').value;
  state.firstChunkMs = null; state.audioSeconds = 0;
  state.done = false; state.error = null;
  status.textContent = 'requesting...';
  const ctx = new (window.AudioContext || window.webkitAudioContext)(
      { sampleRate: SR });
  let playhead = ctx.currentTime + 0.05;
  const t0 = performance.now();
  try {
    const resp = await fetch('/tts', {
      method: 'POST',
      headers: { 'Content-Type': 'application/json' },
      body: JSON.stringify({ text }),
    });
    if (!resp.ok) throw new Error('HTTP ' + resp.status);
    const reader = resp.body.getReader();
    let carry = new Uint8Array(0);
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      if (state.firstChunkMs === null) {
        state.firstChunkMs = performance.now() - t0;
      }
      const buf = new Uint8Array(carry.length + value.length);
      buf.set(carry); buf.set(value, carry.length);
      const usable = buf.length - (buf.length % 4);
      carry = buf.slice(usable);
      if (usable === 0) continue;
      const samples = new Float32Array(buf.buffer.slice(0, usable));
      state.audioSeconds += samples.length / SR;
      const audio = ctx.createBuffer(1, samples.length, SR);
      audio.copyToChannel(samples, 0);
      const src = ctx.createBufferSource();
      src.buffer = audio;
      src.connect(ctx.destination);
      if (playhead < ctx.currentTime) playhead = ctx.currentTime + 0.02;
      src.start(playhead);
      playhead += samples.length / SR;
      status.textContent =
        'first chunk ' + state.firstChunkMs.toFixed(0) + ' ms\\n' +
        state.audioSeconds.toFixed(2) + ' s of audio received';
      fill.style.width =
        Math.min(100, state.audioSeconds * 10) + '%';
    }
    state.done = true;
    status.textContent += '\\ndone';
  } catch (e) {
    state.error = String(e);
    status.textContent = 'error: ' + state.error;
  }
}
document.getElementById('go').addEventListener('click', synthesize);
</script>
</body>
</html>
"""
