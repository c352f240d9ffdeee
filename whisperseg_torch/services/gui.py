r"""Browser GUI (the port of ``whisperseg_tpu/services/gui.py``, which
replaces the reference's Streamlit GUIs, demo.py and scripts/service.py).

    python -m whisperseg_torch.services.gui --backend_address 127.0.0.1:8060
    python -m whisperseg_torch.services.gui --model_path \
        pretrained/whisperseg-base-animal-vad

A self-contained HTML/JS single-page app served by the standard library's
server (Streamlit is not needed):

  * **backend mode** (`--backend_address host:port`): front-end for the
    backend.py model-zoo service — Segment tab (multi-upload -> per-file
    /segment calls -> table + CSV download), Finetune tab (zip upload ->
    /submit-training-request), Model List tab with status/ETA auto-refreshed
    every 5 s (reference scripts/service.py).
  * **standalone mode** (`--model_path ...`): loads one model in-process and
    exposes its own /segment endpoint — the equivalent of demo.py. The model
    runs on the card; ``--device cpu`` runs it on the CPU. Its /segment
    answers an empty table with 400 for a request it cannot read and 500 for
    whatever the segmenter raises, as the backend does.
"""

from __future__ import annotations

import argparse
import io
import threading
import traceback

from .http_util import JsonHTTPServer, Request

PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>WhisperSeg</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 900px; }
 h1 { font-size: 1.4rem; }
 nav button { margin-right: .5rem; padding: .4rem .9rem; border: 1px solid #888;
              background: #eee; cursor: pointer; border-radius: 4px; }
 nav button.active { background: #3b6fd4; color: white; }
 section { display: none; margin-top: 1.2rem; }
 section.active { display: block; }
 table { border-collapse: collapse; margin-top: 1rem; }
 td, th { border: 1px solid #bbb; padding: .25rem .6rem; font-size: .9rem; }
 label { display: block; margin: .5rem 0 .2rem; }
 .status { margin-top: .8rem; color: #444; white-space: pre-wrap; }
 .ok { color: #0a7d28; } .err { color: #b00020; }
</style>
</head>
<body>
<h1>WhisperSeg</h1>
<nav>
 <button data-tab="segment" class="active">Segment</button>
 <button data-tab="finetune" id="finetune-btn">Finetune</button>
 <button data-tab="models" id="models-btn">Model List</button>
</nav>

<section id="segment" class="active">
 <label>Audio files (.wav/.flac/.mp3/.ogg)</label>
 <input type="file" id="audio-files" multiple accept=".wav,.flac,.mp3,.ogg">
 <label>Model</label><select id="segment-model"></select>
 <label>num_trials</label><input type="number" id="num-trials" value="3" min="1">
 <label>min_frequency (blank = model default)</label>
 <input type="number" id="min-frequency">
 <label>spec_time_step (blank = model default)</label>
 <input type="number" id="spec-time-step" step="0.0001">
 <label><input type="checkbox" id="frame-mode"> frame-VAD mode (decoder-free;
 needs a model trained with frame_head)</label>
 <p><button id="run-segment">Segment</button>
    <a id="csv-link" style="display:none" download="segments.csv">Download CSV</a></p>
 <div class="status" id="segment-status"></div>
 <div id="segment-results"></div>
</section>

<section id="finetune">
 <label>Dataset (.zip of wav+json pairs)</label>
 <input type="file" id="dataset-zip" accept=".zip">
 <label>New model name</label><input type="text" id="new-model-name">
 <label>Initial model</label><select id="initial-model"></select>
 <label>num_epochs</label><input type="number" id="num-epochs" value="3">
 <label><input type="checkbox" id="train-frame-head" checked> train the frame
 head (enables frame-VAD mode and learned post-processing)</label>
 <p><button id="run-finetune">Submit training request</button></p>
 <div class="status" id="finetune-status"></div>
</section>

<section id="models">
 <div id="model-table"></div>
</section>

<script>
const BACKEND = "%%BACKEND%%";  // "" => same origin (standalone mode)
const STANDALONE = BACKEND === "";
const api = p => (STANDALONE ? "" : "http://" + BACKEND) + p;

document.querySelectorAll("nav button").forEach(b => b.onclick = () => {
  document.querySelectorAll("nav button").forEach(x => x.classList.remove("active"));
  document.querySelectorAll("section").forEach(x => x.classList.remove("active"));
  b.classList.add("active");
  document.getElementById(b.dataset.tab).classList.add("active");
});
if (STANDALONE) {
  document.getElementById("finetune-btn").style.display = "none";
  document.getElementById("models-btn").style.display = "none";
}

async function refreshModels() {
  if (STANDALONE) {
    document.getElementById("segment-model").innerHTML =
      "<option value=''>loaded model</option>";
    return;
  }
  try {
    const inf = await (await fetch(api("/list-models-available-for-inference"),
                                   {method: "POST"})).json();
    const ft = await (await fetch(api("/list-models-available-for-finetuning"),
                                  {method: "POST"})).json();
    const all = await (await fetch(api("/list-all-models"),
                                   {method: "POST"})).json();
    const fill = (id, rows) => {
      // preserve the user's selection across the 5 s refresh — rewriting
      // innerHTML otherwise snaps the select back to the first entry while
      // they are still filling the form
      const el = document.getElementById(id);
      const prev = el.value;
      el.innerHTML = rows.map(m => `<option>${m.model_name}</option>`).join("");
      if (rows.some(m => m.model_name === prev)) el.value = prev;
    };
    fill("segment-model", inf.response);
    fill("initial-model", ft.response);
    const icon = s => s === "ready" ? "&#9989;" :
                      (s === "training" ? "&#9203;" : "&#8987;");
    document.getElementById("model-table").innerHTML =
      "<table><tr><th>model</th><th>status</th><th>ETA</th></tr>" +
      all.response.map(m => `<tr><td>${m.model_name}</td>` +
        `<td>${icon(m.status)} ${m.status}</td><td>${m.eta}</td></tr>`).join("") +
      "</table>";
  } catch (e) { /* backend unreachable; retry on next tick */ }
}
refreshModels();
setInterval(refreshModels, 5000);

document.getElementById("run-segment").onclick = async () => {
  const files = document.getElementById("audio-files").files;
  const status = document.getElementById("segment-status");
  if (!files.length) { status.textContent = "Choose at least one audio file."; return; }
  status.textContent = "";
  const rows = [];
  for (const f of files) {
    status.textContent = `Segmenting ${f.name} ...`;
    const fd = new FormData();
    fd.append("audio_file", f);
    const model = document.getElementById("segment-model").value;
    if (model) fd.append("model_name", model);
    fd.append("num_trials", document.getElementById("num-trials").value);
    const mf = document.getElementById("min-frequency").value;
    if (mf) fd.append("min_frequency", mf);
    const st = document.getElementById("spec-time-step").value;
    if (st) fd.append("spec_time_step", st);
    if (document.getElementById("frame-mode").checked) fd.append("frame_mode", "1");
    const r = await fetch(api("/segment"), {method: "POST", body: fd});
    const p = await r.json();
    if (!r.ok) {
      status.innerHTML = `<span class="err">${f.name}: ${p.error ||
        "the audio could not be read"} (${r.status})</span>`;
      return;
    }
    for (let i = 0; i < (p.onset || []).length; i++)
      rows.push([f.name, p.onset[i], p.offset[i], p.cluster[i]]);
  }
  status.innerHTML = `<span class="ok">Done: ${rows.length} segments.</span>`;
  document.getElementById("segment-results").innerHTML =
    "<table><tr><th>filename</th><th>onset</th><th>offset</th><th>cluster</th></tr>" +
    rows.map(r => `<tr><td>${r.join("</td><td>")}</td></tr>`).join("") + "</table>";
  const csv = "filename,onset,offset,cluster\\n" +
              rows.map(r => r.join(",")).join("\\n");
  const link = document.getElementById("csv-link");
  link.href = URL.createObjectURL(new Blob([csv], {type: "text/csv"}));
  link.style.display = "inline";
};

document.getElementById("run-finetune").onclick = async () => {
  const status = document.getElementById("finetune-status");
  const zip = document.getElementById("dataset-zip").files[0];
  if (!zip) { status.textContent = "Choose a dataset zip."; return; }
  const fd = new FormData();
  fd.append("zip", zip);
  fd.append("model_name", document.getElementById("new-model-name").value);
  fd.append("initial_model_name", document.getElementById("initial-model").value);
  fd.append("num_epochs", document.getElementById("num-epochs").value);
  // always send the field: the backend defaults a MISSING frame_head to 1,
  // so omitting it when unchecked would silently re-enable the head
  fd.append("frame_head",
            document.getElementById("train-frame-head").checked ? "1" : "0");
  const r = await fetch(api("/submit-training-request"), {method: "POST", body: fd});
  const body = await r.json();
  status.innerHTML = r.ok
    ? `<span class="ok">Submitted — track progress in the Model List tab.</span>`
    : `<span class="err">${body.error || "submission failed"}</span>`;
};
</script>
</body>
</html>
"""


def build_app(backend_address: str = "", segmenter=None,
              batch_size: int = 8) -> JsonHTTPServer:
    app = JsonHTTPServer()
    page = PAGE.replace("%%BACKEND%%", backend_address)

    @app.route("/", methods=["GET"])
    def index(req: Request):
        return {"__raw_html__": page}, 200

    # Serve raw HTML: special-case the dispatcher via a tiny wrapper route.
    handler_cls = app.make_handler()
    orig_send = handler_cls._send

    def _send(self, payload, code):
        if isinstance(payload, dict) and "__raw_html__" in payload:
            body = payload["__raw_html__"].encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        orig_send(self, payload, code)

    handler_cls._send = _send
    app.make_handler = lambda: handler_cls  # type: ignore

    if segmenter is not None:
        sem = threading.Semaphore()

        @app.route("/segment", methods=["POST"])
        def segment(req: Request):
            from ..audio.io import load_audio

            with sem:
                try:  # a fault here is the client's: empty table, 400
                    num_trials = req.form_get("num_trials", type=int, default=3)
                    min_frequency = req.form_get("min_frequency", type=int)
                    spec_time_step = req.form_get("spec_time_step", type=float)
                    channel_id = req.form_get("channel_id", type=int, default=0)
                    frame_mode = req.form_get("frame_mode", type=int, default=0)
                    audio, sr = load_audio(io.BytesIO(req.files["audio_file"]),
                                           mono=False, channel_id=channel_id)
                    if audio.ndim == 2:
                        audio = audio[channel_id]
                except Exception:
                    traceback.print_exc()
                    return {"onset": [], "offset": [], "cluster": []}, 400
                # whatever the segmenter raises answers 500
                if frame_mode:
                    prediction = segmenter.segment_from_frames(
                        audio, sr, min_frequency=min_frequency,
                        spec_time_step=spec_time_step,
                        batch_size=batch_size)
                else:
                    prediction = segmenter.segment(
                        audio, sr, min_frequency=min_frequency,
                        spec_time_step=spec_time_step, num_trials=num_trials,
                        batch_size=batch_size)
                return prediction, 200

    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", default=8081, type=int)
    parser.add_argument("--backend_address", default="",
                        help="host:port of a running backend.py (backend mode)")
    parser.add_argument("--model_path", default=None,
                        help="load a model in-process (standalone demo mode)")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--compute_type", default="bfloat16",
                        choices=["float32", "bfloat16", "int8", "int4"])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, for the standalone "
                             "model")
    args = parser.parse_args(argv)

    if not args.model_path and not args.backend_address:
        # neither mode selected: serve the shipped default model standalone
        from ..hub import default_pretrained_model

        args.model_path = default_pretrained_model()
        if args.model_path:
            print(f"using the shipped default model: {args.model_path}")
    segmenter = None
    if args.model_path:
        from ..segmenter import Segmenter

        segmenter = Segmenter.from_pretrained(
            args.model_path, inference_dtype=args.compute_type,
            device=args.device)
    app = build_app(args.backend_address, segmenter, args.batch_size)
    print(f"GUI at http://0.0.0.0:{args.port}/")
    app.serve("0.0.0.0", args.port)


if __name__ == "__main__":
    main()
