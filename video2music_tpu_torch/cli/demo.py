"""First-party web demo UI (``python -m video2music_tpu_torch.cli.demo``).

The reference exposes its product as a gradio Space (``video2music.py:1``
imports gradio; ``README.md:14-27`` documents the demo flow: pick a video,
primer chords, a key, and get back the video with generated background
music). gradio is not a dependency of this framework, so the demo surface
is a small stdlib ``http.server`` app over the same
:class:`~video2music_tpu_torch.pipeline.api.Video2music` API (the JAX
package's demo on the port, plus ``-device``: ``cuda`` unless given;
without CUDA it raises):

  * ``GET /`` — form: test-split video id (or an uploaded video when
    CLIP/MaxViT weights + ffmpeg are available), primer chords, key,
    temperature, primer length;
  * ``POST /generate`` — runs the pipeline, shows the chord sequence and
    links to the rendered outputs;
  * ``GET /files/...`` — serves the generated .lab/.mid/.flac/.mp4.

Everything heavyweight is lazy and capability-gated exactly like the CLI:
with only precomputed dataset features it still generates chords + MIDI.
"""

from __future__ import annotations

import html
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

FORM_PAGE = """<!doctype html>
<html><head><title>video2music-tpu demo</title>
<style>
 body {{ font-family: sans-serif; max-width: 46rem; margin: 2rem auto; }}
 label {{ display:block; margin-top: .8rem; font-weight: 600; }}
 input, select {{ width: 100%; padding: .4rem; }}
 button {{ margin-top: 1rem; padding: .5rem 1.4rem; }}
 .note {{ color: #555; font-size: .9rem; }}
</style></head><body>
<h1>video2music-tpu</h1>
<p class="note">Affective Multimodal Transformer demo — pick a test video
(precomputed features) and primer chords; the model generates a chord
sequence, per-second density/loudness and an instrument mix, and renders
MIDI{audio_note}.</p>
<form method="post" action="/generate">
<label>Test video id</label>
<select name="test_id">{options}</select>
<label>Primer chords (e.g. "C Am F G"; empty = dataset primer)</label>
<input name="primer" value="">
<label>Key (e.g. "C major"; empty = auto from emotion)</label>
<input name="key" value="">
<label>Temperature</label>
<input name="temperature" value="1.0">
<label>Primer length (chords)</label>
<input name="num_prime_chord" value="30">
<button type="submit">Generate</button>
</form></body></html>
"""

RESULT_PAGE = """<!doctype html>
<html><head><title>video2music-tpu demo</title>
<style>
 body {{ font-family: sans-serif; max-width: 46rem; margin: 2rem auto; }}
 code {{ background: #f4f4f4; padding: .15rem .3rem; }}
</style></head><body>
<h1>Generated</h1>
<p><b>Key:</b> {key}</p>
<p><b>Chords:</b></p>
<p><code>{chords}</code></p>
<ul>{links}</ul>
<p><a href="/">&#8592; generate another</a></p>
</body></html>
"""


class DemoApp:
    """Holds the models + dataset; handler instances delegate here."""

    def __init__(self, dataset_dir: str = "./dataset",
                 output_dir: str = "./demo_output",
                 v2m=None, test_ds=None, motion_type: int = 0,
                 **v2m_kwargs):
        self.dataset_dir = dataset_dir
        self.output_dir = output_dir
        self.motion_type = motion_type
        self._v2m = v2m
        self._test_ds = test_ds
        self._v2m_kwargs = v2m_kwargs
        self._lock = threading.Lock()
        self._run = 0

    @property
    def test_ds(self):
        if self._test_ds is None:
            from ..data import create_vevo_datasets
            _, _, self._test_ds = create_vevo_datasets(
                dataset_root=self.dataset_dir, motion_type=self.motion_type)
        return self._test_ds

    @property
    def v2m(self):
        if self._v2m is None:
            from ..pipeline.api import Video2music
            self._v2m = Video2music(motion_type=self.motion_type,
                                    **self._v2m_kwargs)
        return self._v2m

    def index_html(self) -> str:
        from ..pipeline import video_io
        ids = self.test_ds.ids
        options = "".join(f'<option value="{html.escape(i)}">'
                          f"{html.escape(i)}</option>" for i in ids)
        note = (" and audio/video" if video_io.has_fluidsynth()
                else " (no fluidsynth on this host — MIDI only)")
        return FORM_PAGE.format(options=options or "<option>none</option>",
                                audio_note=note)

    def generate(self, form: dict) -> str:
        test_id = form.get("test_id", [""])[0]
        primer = form.get("primer", [""])[0].strip()
        key = form.get("key", [""])[0].strip() or None
        temperature = float(form.get("temperature", ["1.0"])[0] or 1.0)
        num_prime = int(form.get("num_prime_chord", ["30"])[0] or 30)

        ds = self.test_ds
        ids = ds.ids
        idx = ids.index(test_id) if test_id in ids else 0
        sample = ds[idx]
        feats = {k: sample[k] for k in
                 ("semantic", "emotion", "scene_offset", "motion")}
        if not primer:
            from ..core import constants as C
            from ..core.vocab import chord_inv_dict
            inv = chord_inv_dict()
            n = min(num_prime, int((sample["chord"] != C.CHORD_PAD).sum()))
            primer = " ".join(
                inv[int(c)].replace(":min", "m").replace(":", "")
                for c in sample["chord"][:n] if int(c) < C.CHORD_END)

        # serialize generation: the pipeline's models and caches are not
        # safe under the threading server's concurrency
        with self._lock:
            self._run += 1
            out_dir = os.path.join(self.output_dir, f"run_{self._run:03d}")
            result = self.v2m.generate(primer=primer, key=key,
                                       temperature=temperature,
                                       features=feats, output_dir=out_dir)

        rel = os.path.basename(out_dir)
        links = []
        for label, p in (("MIDI", result.midi_path),
                         ("Audio", result.audio_path),
                         ("Video", result.video_path)):
            if p:
                name = os.path.basename(p)
                links.append(f'<li><a href="/files/{rel}/{name}">'
                             f"{label}: {html.escape(name)}</a></li>")
        return RESULT_PAGE.format(
            key=html.escape(str(result.key)),
            chords=html.escape(" ".join(result.chords[:64])),
            links="".join(links))

    def file_bytes(self, path: str) -> Optional[bytes]:
        full = os.path.realpath(os.path.join(self.output_dir, path))
        root = os.path.realpath(self.output_dir)
        if not full.startswith(root + os.sep) or not os.path.isfile(full):
            return None
        with open(full, "rb") as f:
            return f.read()


def make_server(app: DemoApp, host: str = "127.0.0.1", port: int = 0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path == "/index.html":
                self._send(200, app.index_html().encode())
            elif self.path.startswith("/files/"):
                data = app.file_bytes(
                    urllib.parse.unquote(self.path[len("/files/"):]))
                if data is None:
                    self._send(404, b"not found", "text/plain")
                else:
                    self._send(200, data, "application/octet-stream")
            elif self.path == "/health":
                self._send(200, b'{"ok": true}', "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", "0"))
            form = urllib.parse.parse_qs(
                self.rfile.read(length).decode("utf-8"))
            try:
                self._send(200, app.generate(form).encode())
            except Exception as e:  # surface errors in the browser
                msg = f"<h1>error</h1><pre>{html.escape(str(e))}</pre>"
                self._send(500, msg.encode())

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="video2music-tpu web demo")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=7860)  # gradio's default
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-output_dir", default="./demo_output")
    p.add_argument("-music_gen_version", default="2.2")
    p.add_argument("-regModel", default="bimamba+")
    p.add_argument("-motion_type", type=int, default=0)
    p.add_argument("-amt_weights", default=None)
    p.add_argument("-reg_weights", default=None)
    from .train_amt import add_device_flag
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..train.step import resolve_device
    device = resolve_device(args.device)

    app = DemoApp(dataset_dir=args.dataset_dir, output_dir=args.output_dir,
                  motion_type=args.motion_type,
                  music_gen_version=args.music_gen_version,
                  reg_model=args.regModel,
                  amt_checkpoint=args.amt_weights,
                  reg_checkpoint=args.reg_weights, device=device)
    srv = make_server(app, args.host, args.port)
    print(f"demo listening on http://{args.host}:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
