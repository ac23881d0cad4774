"""CLI: production serving — HTTP JSON API with dynamic request batching.

    python -m video2music_tpu_torch.cli.serve -dataset_dir ./dataset -port 8080

No reference counterpart (the reference's serving surface is a gradio
Space calling ``generate()`` one request at a time, reference:
``video2music.py:1``, ``README.md:14-27``). Concurrent requests coalesce
into one batched decode via ``pipeline.serving.DynamicBatcher`` (the
batched decode kernels take every row in one launch a layer, see
``pipeline/api.generate_batch``); all device work stays on the batcher's
single worker thread, so the threading HTTP server needs no dispatch
lock. The JAX package's server on the port's ``Video2music``, plus
``-device`` (``cuda`` unless given; without CUDA it raises).

API:
  GET  /healthz   -> {"ok": true, "stats": {...}}
  POST /generate  JSON body:
      {"test_id": "<dataset id>" | "features": {"semantic": [[...]], ...}
         | "video": "/server/local/clip.mp4",
       "primer": "C Am F G", "key": "C major", "temperature": 1.0,
       "stream": false, "priority": 0, "deadline_s": null}
    "priority" (higher gathers first) and "deadline_s" (fail with 504 if
    the decode hasn't started within the budget) feed the batcher's
    scheduling; see pipeline/serving.py.
    -> {"chords": [...], "key": ..., "midi_path": ..., "batch_width": B}
    With "stream": true the response is chunked NDJSON: first
    {"stage": "decoded", "chords": [...], "key": ...} as soon as the
    decode lands, then {"stage": "done", ...full result...} after
    host-side MIDI/audio rendering.
  POST /reload    {"amt_checkpoint": path?, "reg_checkpoint": path?}
    -> hot-swaps model weights between batches (port checkpoints,
       ``Video2music.load_checkpoints``).
  Overload: a full request queue returns 503 (bounded queue in
  ``pipeline.serving``; see ``-max_queue``).

``"video"`` paths are SERVER-local files (the batcher coalesces
extraction across concurrent requests into shared CLIP/MaxViT chunks —
``api.extract_features_batch``); this CLI loads no extractor weights, so
its requests are ``test_id``/``features``, matching the reference's
offline dataset split.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


class ServeApp:
    """Holds the model, dataset, and batcher; handlers delegate here."""

    def __init__(self, dataset_dir: str = "./dataset",
                 output_dir: str = "./serve_output",
                 v2m=None, test_ds=None, motion_type: int = 0,
                 max_batch: int = 16, max_wait_ms: int = 30,
                 max_queue: int = 256, **v2m_kwargs):
        self.dataset_dir = dataset_dir
        self.output_dir = output_dir
        self.motion_type = motion_type
        self._v2m = v2m
        self._test_ds = test_ds
        self._v2m_kwargs = v2m_kwargs
        self._batcher = None
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._max_queue = max_queue
        # lazy-init guard: concurrent first requests on the threading
        # server must not build two models / two batcher workers
        self._init_lock = threading.Lock()

    @property
    def test_ds(self):
        with self._init_lock:
            if self._test_ds is None:
                from ..data import create_vevo_datasets
                _, _, self._test_ds = create_vevo_datasets(
                    dataset_root=self.dataset_dir,
                    motion_type=self.motion_type)
            return self._test_ds

    @property
    def batcher(self):
        with self._init_lock:
            if self._batcher is None:
                from ..pipeline.serving import DynamicBatcher
                if self._v2m is None:
                    from ..pipeline.api import Video2music
                    self._v2m = Video2music(motion_type=self.motion_type,
                                            **self._v2m_kwargs)
                self._batcher = DynamicBatcher(
                    self._v2m, max_batch=self._max_batch,
                    max_wait_ms=self._max_wait_ms,
                    max_queue=self._max_queue,
                    output_dir=self.output_dir)
            return self._batcher

    def stop(self):
        if self._batcher is not None:
            self._batcher.stop()

    # ------------------------------------------------------------------
    def _features_for(self, body: Dict) -> Optional[Dict[str, np.ndarray]]:
        if "video" in body:
            path = str(body["video"])
            if not os.path.isfile(path):
                raise ValueError(f"video path not found on server: {path!r}")
            return None  # extracted by the batcher group-wise
        if "features" in body:
            f = body["features"]
            missing = [k for k in ("semantic", "emotion", "scene_offset",
                                   "motion") if k not in f]
            if missing:
                raise ValueError(f"features missing keys: {missing}")
            return {k: np.asarray(f[k], np.float32)
                    for k in ("semantic", "emotion", "scene_offset",
                              "motion")}
        test_id = body.get("test_id")
        ids = self.test_ds.ids
        if test_id not in ids:
            raise KeyError(f"unknown test_id {test_id!r}; have {ids[:5]}...")
        sample = self.test_ds[ids.index(test_id)]
        return {k: sample[k] for k in
                ("semantic", "emotion", "scene_offset", "motion")}

    def handle_generate(self, body: Dict, on_decoded=None) -> Dict:
        # KeyError may escape only from the test_id lookup (-> 404); any
        # KeyError out of the batched pipeline is a server bug (-> 500)
        features = self._features_for(body)
        request = dict(
            primer=body.get("primer", ""),
            key=body.get("key"),
            transposition_value=int(body.get("transposition_value", 0)))
        if features is None:
            request["video"] = str(body["video"])
        else:
            request["features"] = features
        deadline_s = body.get("deadline_s")
        try:
            fut = self.batcher.submit(
                request, temperature=float(body.get("temperature", 1.0)),
                on_decoded=on_decoded,
                priority=int(body.get("priority", 0)),
                deadline_s=None if deadline_s is None else float(deadline_s))
            result, width = fut.result()
        except KeyError as exc:
            raise RuntimeError(f"pipeline KeyError: {exc}") from exc
        return {
            "chords": result.chords,
            "key": result.key,
            "midi_path": result.midi_path,
            "audio_path": result.audio_path,
            "video_path": result.video_path,
            "batch_width": width,
        }

    def handle_reload(self, body: Dict) -> Dict:
        amt = body.get("amt_checkpoint")
        reg = body.get("reg_checkpoint")
        if not amt and not reg:
            raise ValueError("need amt_checkpoint and/or reg_checkpoint")
        fut = self.batcher.submit_control(
            lambda v2m: v2m.load_checkpoints(amt, reg))
        fut.result()  # surface load errors to the caller
        return {"ok": True, "amt_checkpoint": amt, "reg_checkpoint": reg}


def make_server(app: ServeApp, host: str = "127.0.0.1", port: int = 0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = (app.batcher.stats if app._batcher is not None
                         else {})
                self._json(200, {"ok": True, "stats": stats})
            else:
                self._json(404, {"error": "not found"})

        def _stream_generate(self, body):
            """Chunked NDJSON: a 'decoded' line as soon as the decode
            fetch lands, a 'done' line after host-side rendering."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payload: Dict):
                data = (json.dumps(payload) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

            def on_decoded(payload):
                chunk({"stage": "decoded",
                       "chords": payload["chords"],
                       "key": payload["key"]})

            try:
                result = app.handle_generate(body, on_decoded=on_decoded)
                chunk(dict(result, stage="done"))
            except Exception as exc:  # noqa: BLE001 — headers already
                # sent; the error must travel in-stream
                chunk({"stage": "error",
                       "error": f"{type(exc).__name__}: {exc}"})
            self.wfile.write(b"0\r\n\r\n")

        def do_POST(self):
            from ..pipeline.serving import DeadlineExceeded, Overloaded

            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/generate":
                    if body.get("stream"):
                        self._stream_generate(body)
                    else:
                        self._json(200, app.handle_generate(body))
                elif self.path == "/reload":
                    self._json(200, app.handle_reload(body))
                else:
                    self._json(404, {"error": "not found"})
            except Overloaded as exc:   # bounded queue full -> shed load
                self._json(503, {"error": str(exc)})
            except DeadlineExceeded as exc:  # deadline_s elapsed queued
                self._json(504, {"error": str(exc)})
            except KeyError as exc:     # unknown test_id
                self._json(404, {"error": str(exc)})
            except (ValueError, json.JSONDecodeError) as exc:  # bad payload
                self._json(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — serving boundary
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description="Video2music serving API")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-output_dir", default="./serve_output")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-motion_type", type=int, default=0)
    p.add_argument("-music_gen_version", default="2.2")
    p.add_argument("-regModel", default="bimamba+")
    p.add_argument("-amt_checkpoint", default=None)
    p.add_argument("-reg_checkpoint", default=None)
    p.add_argument("-max_batch", type=int, default=16)
    p.add_argument("-max_wait_ms", type=int, default=30)
    p.add_argument("-max_queue", type=int, default=256)
    from .train_amt import add_device_flag
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..train.step import resolve_device
    device = resolve_device(args.device)
    app = ServeApp(
        dataset_dir=args.dataset_dir, output_dir=args.output_dir,
        motion_type=args.motion_type, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        music_gen_version=args.music_gen_version, reg_model=args.regModel,
        amt_checkpoint=args.amt_checkpoint,
        reg_checkpoint=args.reg_checkpoint, device=device)
    server = make_server(app, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms}ms)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()


if __name__ == "__main__":
    main()
