"""Live interactive debug GUI, the tweakpane analog: the port of the JAX
package's ``tools/debug_gui.py``.

The reference ships interactive option panels (`example/SSGIDebugGUI.js:
21-130`, `HBAODebugGUI.js`) with live sliders over every effect option,
a debug-texture selector routing any intermediate buffer to the screen
(`SSGIEffect.js:228-251`), and a copy-config button. Headless, the
equivalent is a standard-library HTTP server driving a live composer:
an option change renders at once (a uniform option changes the effect in
place; a static option rebuilds the effect and clears the composer's
state), the frame comes back as a PNG, and ``/config`` returns the
current constructor keywords.

Run:  python -m realism_effects_tpu_torch.tools.debug_gui [--device cpu]
      [--scene showcase] [--port 8731]
then open http://localhost:8731/. It runs on ``cuda`` unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading

import numpy as np

# ---------------------------------------------------------------------------
# Option schema: name -> (kind, lo, hi) per effect; the GUIs' slider ranges
# (`SSGIDebugGUI.js:21-130`)
# ---------------------------------------------------------------------------

SSGI_OPTIONS = {
    "distance": ("float", 0.1, 50.0),
    "thickness": ("float", 0.1, 50.0),
    "env_blur": ("float", 0.0, 1.0),
    "steps": ("int", 1, 64),
    "refine_steps": ("int", 0, 8),
    "denoise_iterations": ("int", 0, 4),
    "radius": ("float", 1.0, 12.0),
    "phi": ("float", 0.0, 1.0),
    "luma_phi": ("float", 0.0, 20.0),
    "depth_phi": ("float", 0.0, 20.0),
    "normal_phi": ("float", 0.0, 100.0),
    "roughness_phi": ("float", 0.0, 100.0),
    "specular_phi": ("float", 0.0, 100.0),
    "importance_sampling": ("bool",),
    "missed_rays": ("bool",),
    "resolution_scale": ("float", 0.25, 1.0),
    "denoise_mode": ("enum", "full", "full_temporal", "denoised",
                     "temporal"),
    "output_texture": ("enum", "", "diffuse", "specular",
                       "temporal_diffuse", "temporal_specular",
                       "denoised_diffuse", "denoised_specular", "composed"),
}

HBAO_OPTIONS = {
    "spp": ("int", 1, 32),
    "distance": ("float", 0.1, 10.0),
    "distance_power": ("float", 0.1, 4.0),
    "power": ("float", 0.1, 8.0),
    "bias": ("float", 0.0, 100.0),
    "thickness": ("float", 0.0, 1.0),
    "denoise_iterations": ("int", 0, 4),
    "resolution_scale": ("float", 0.25, 1.0),
}

#: options that are per-frame uniforms (changed in place, no rebuild)
UNIFORM_OPTIONS = {"distance", "thickness", "env_blur", "power", "bias",
                   "distance_power"}

EFFECTS = {
    "ssgi": SSGI_OPTIONS,
    "ssr": SSGI_OPTIONS,
    "hbao": HBAO_OPTIONS,
    "gtao": HBAO_OPTIONS,
}


class GuiState:
    """The live composer: scene ``scene_name`` of the demo, effect
    ``effect_name`` (+ TRAA when ``aa``) at ``size`` x ``size`` on
    ``device`` (``cuda`` unless another device is asked for)."""

    def __init__(self, scene_name: str, effect_name: str, size: int,
                 aa: bool, device=None):
        from ..composer import resolve_device

        self.lock = threading.Lock()
        self.scene_name = scene_name
        self.effect_name = effect_name
        self.size = size
        self.aa = aa
        self.device = resolve_device(device)
        self.kwargs: dict = {}
        self.frame = 0
        self._build()

    def _build(self):
        from .. import EffectComposer, TRAAEffect
        from .demo import build_scene

        scene, cam, animate = build_scene(self.scene_name, self.device)
        self.scene, self.cam, self.animate = scene, cam, animate
        self.composer = EffectComposer(scene, cam, self.size, self.size,
                                       device=self.device)
        self.composer.add_effect(self._make_effect())
        if self.aa:
            self.composer.add_effect(TRAAEffect())
        self.frame = 0

    def _make_effect(self):
        from .. import GTAOEffect, HBAOEffect, SSGIEffect, SSREffect

        cls = {"ssgi": SSGIEffect, "ssr": SSREffect, "hbao": HBAOEffect,
               "gtao": GTAOEffect}[self.effect_name]
        return cls(**{k: v for k, v in self.kwargs.items() if v != ""})

    def set_option(self, name: str, value):
        schema = EFFECTS[self.effect_name]
        if name not in schema:
            raise KeyError(name)
        kind = schema[name][0]
        if kind == "int":
            value = int(value)
        elif kind == "float":
            value = float(value)
        elif kind == "bool":
            value = value in (True, "true", "1", 1)
        self.kwargs[name] = value
        effect = self.composer.effects[0]
        if kind in ("float", "int") and name in UNIFORM_OPTIONS and \
                hasattr(effect, name):
            # uniform route: change in place (`SSGIEffect.js`'s uniform
            # branch of makeOptionsReactive)
            setattr(effect, name, value)
        else:
            # define route: rebuild the effect and reset the history
            self.composer.effects[0] = self._make_effect()
            self.composer._state = None

    def render_png(self, frames: int = 1) -> bytes:
        from PIL import Image

        for _ in range(max(frames, 1)):
            if self.animate is not None:
                self.animate(self.frame)
            img = self.composer.render(dt=1 / 60)
            self.frame += 1
        arr = img.detach().cpu().numpy()
        arr = np.clip(arr, 0.0, 1.0) ** (1 / 2.2)
        arr = (arr * 255).astype(np.uint8)[::-1]  # row 0 = bottom
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()


PAGE = """<!DOCTYPE html>
<html><head><title>realism_effects_tpu_torch debug GUI</title><style>
body { font-family: system-ui, sans-serif; background: #16161c;
       color: #ddd; display: flex; gap: 24px; padding: 16px; }
#panel { width: 330px; }
#panel h2 { font-size: 15px; margin: 4px 0 10px; }
.row { display: flex; align-items: center; margin: 5px 0; font-size: 12px; }
.row label { flex: 0 0 128px; }
.row input[type=range] { flex: 1; }
.row output { flex: 0 0 52px; text-align: right; }
select, button { background: #24242e; color: #ddd; border: 1px solid #444;
                 border-radius: 4px; padding: 3px 6px; font-size: 12px; }
#frame { image-rendering: pixelated; border: 1px solid #333;
         width: 512px; height: 512px; }
#status { font-size: 11px; color: #8a8; min-height: 16px; }
#config { font-size: 10px; white-space: pre-wrap; color: #aaa; }
</style></head><body>
<div id="panel">
  <h2>realism_effects_tpu_torch — debug GUI</h2>
  <div class="row"><label>effect</label>
    <select id="effect">__EFFECTS__</select></div>
  <div id="options"></div>
  <div class="row"><button id="copy">copy config</button>
    <button id="step">advance 8 frames</button></div>
  <div id="status"></div>
  <pre id="config"></pre>
</div>
<img id="frame" width="512" height="512">
<script>
const $ = (s) => document.querySelector(s);
let schema = {};
async function api(path, body) {
  const r = await fetch(path, body ? {method: "POST",
    body: JSON.stringify(body)} : {});
  return r.json();
}
function slider(name, spec, value) {
  const row = document.createElement("div");
  row.className = "row";
  if (spec[0] === "enum") {
    const opts = spec.slice(1).map(v =>
      `<option ${v === value ? "selected" : ""}>${v}</option>`).join("");
    row.innerHTML = `<label>${name}</label><select>${opts}</select>`;
    row.querySelector("select").onchange = (e) => setOpt(name, e.target.value);
  } else if (spec[0] === "bool") {
    row.innerHTML = `<label>${name}</label><input type="checkbox"
      ${value ? "checked" : ""}>`;
    row.querySelector("input").onchange = (e) => setOpt(name, e.target.checked);
  } else {
    const step = spec[0] === "int" ? 1 : (spec[2] - spec[1]) / 200;
    row.innerHTML = `<label>${name}</label>
      <input type="range" min="${spec[1]}" max="${spec[2]}" step="${step}"
             value="${value}"><output>${value}</output>`;
    const inp = row.querySelector("input");
    inp.oninput = (e) => row.querySelector("output").textContent =
        e.target.value;
    inp.onchange = (e) => setOpt(name, parseFloat(e.target.value));
  }
  return row;
}
async function refresh() {
  const s = await api("/state");
  schema = s.schema;
  const box = $("#options");
  box.innerHTML = "";
  for (const [name, spec] of Object.entries(s.schema))
    box.appendChild(slider(name, spec, s.values[name]));
  $("#effect").value = s.effect;
  $("#frame").src = "data:image/png;base64," + s.png;
  $("#config").textContent = s.config;
}
async function setOpt(name, value) {
  $("#status").textContent = "rendering…";
  const s = await api("/set", {name, value});
  $("#frame").src = "data:image/png;base64," + s.png;
  $("#config").textContent = s.config;
  $("#status").textContent = s.note || "";
}
$("#effect").onchange = async (e) => {
  $("#status").textContent = "rebuilding…";
  await api("/effect", {name: e.target.value});
  await refresh();
  $("#status").textContent = "";
};
$("#step").onclick = async () => {
  $("#status").textContent = "rendering…";
  const s = await api("/advance", {frames: 8});
  $("#frame").src = "data:image/png;base64," + s.png;
  $("#status").textContent = "";
};
$("#copy").onclick = () =>
  navigator.clipboard.writeText($("#config").textContent);
refresh();
</script></body></html>"""


def make_handler(state: GuiState):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _payload(self, note=""):
            png = base64.b64encode(state.render_png()).decode()
            cfg = (f"{state.effect_name.upper()}Effect("
                   + ", ".join(f"{k}={v!r}"
                               for k, v in state.kwargs.items()) + ")")
            return {"png": png, "config": cfg, "note": note}

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                opts = "".join(
                    f"<option value='{n}'"
                    f"{' selected' if n == state.effect_name else ''}>"
                    f"{n}</option>" for n in EFFECTS)
                body = PAGE.replace("__EFFECTS__", opts).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/state":
                with state.lock:
                    p = self._payload()
                    p["schema"] = {k: list(v) for k, v in
                                   EFFECTS[state.effect_name].items()}
                    p["values"] = {
                        k: state.kwargs.get(k, "")
                        for k in EFFECTS[state.effect_name]}
                    p["effect"] = state.effect_name
                    self._json(p)
            elif self.path == "/config":
                with state.lock:
                    self._json({"kwargs": state.kwargs,
                                "effect": state.effect_name})
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            with state.lock:
                if self.path == "/set":
                    state.set_option(req["name"], req["value"])
                    uniform = req["name"] in UNIFORM_OPTIONS
                    self._json(self._payload(
                        "" if uniform else "rebuilt (static option)"))
                elif self.path == "/effect":
                    state.effect_name = req["name"]
                    state.kwargs = {}
                    state._build()
                    self._json({"ok": True})
                elif self.path == "/advance":
                    self._json(self._payload())
                else:
                    self.send_error(404)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m realism_effects_tpu_torch.tools.debug_gui")
    ap.add_argument("--scene", default="showcase")
    ap.add_argument("--effect", default="ssgi", choices=list(EFFECTS))
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--port", type=int, default=8731)
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    state = GuiState(args.scene, args.effect, args.size, not args.no_aa,
                     device=args.device)
    print(f"warming up ({args.scene}, {args.effect})...", flush=True)
    state.render_png(frames=2)

    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(state))
    print(f"debug GUI at http://localhost:{args.port}/", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
