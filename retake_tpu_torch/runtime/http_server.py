"""HTTP front end over the continuous-batching server (port of
``retake_tpu/runtime/http_server.py``), standard library only.

One worker thread does all device work (the ``OnlineHandle`` serving
loop); HTTP handler threads do host work only (frame loading, the
processor, JSON) and wait on futures and queues.

Endpoints:
  GET  /healthz       -> {"ok": true, "batch_slots": ..., "max_new_tokens": ...}
  GET  /metrics       -> the server's ``stats``, the cache entry counts and
                         the uptime
  POST /v1/generate   -> body JSON:
    {"question": str,              # required
     "video_path": str?,           # a video file or a frame directory on the server
     "max_new_tokens": int?,       # the request's budget (server default)
     "extraction_fps": float?,     # a frame directory's extraction fps (25)
     "deadline_s": float?,         # seconds from submission
     "stream": bool?}              # server-sent events (default false)

  stream false -> {"tokens": [...], "text": str, "ttft_s": float,
                   "latency_s": float, "cancelled": bool[, "error": str]}
                  (500 when the admission failed)
  stream true  -> text/event-stream: one ``data: {"tokens": [...],
                  "text_delta": str}`` event per harvested segment, then
                  ``data: {"done": true, ...the blocking body...}``. A dropped
                  connection cancels the request in the server.
  A full backlog (``max_queue``) answers 503 with ``Retry-After``; a body
  that cannot be turned into a request answers 400.

With a vision or prefix cache on the server, a request about a
``video_path`` is keyed ``f"{path}|fps={fps}"``; a handler thread peeks
both caches with one dict ``get`` each (the worker mutates them only by
single dict operations), and a hit skips the frame loading and the
processor's pixel work as well.

Under tensor parallelism (an engine built with ``tp=``) every rank
constructs and starts the server: rank 0 binds the socket, runs the HTTP
thread, loads and processes the frames, and its serving worker sends each
request it admits to the other ranks, whose ``start()`` runs a follower
worker (``ContinuousServer.start_online``) and binds nothing. ``shutdown()``
on rank 0 ends every rank's worker; another rank's ``shutdown()`` waits for
that.

Start on the card (random weights; a real tokenizer is not in the repo):
``RetakeHTTPServer(engine, Qwen2VLProcessor(tokenizer), rt, port=8000,
batch_slots=4, vision_cache_slots=2, prefix_cache_slots=2).start()``
with ``engine = Qwen2VLEngine(cfg, model, rt, device="cuda")``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from retake_tpu_torch.data.video import fetch_video
from retake_tpu_torch.runtime.serve import ContinuousServer


class RetakeHTTPServer:
    """See the module docstring. ``start()`` returns once the socket is
    bound (``port=0`` picks a free one, read back from ``port``);
    ``shutdown()`` stops HTTP, then drains and joins the serving loop.
    ``leader``: this process serves HTTP (tp = 1, or rank 0 under TP)."""

    def __init__(
        self,
        engine,
        processor,
        rt,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_queue: Optional[int] = None,  # submit backlog bound (503 past it)
        **server_kwargs,
    ):
        self.max_queue = max_queue
        self.engine = engine
        self.processor = processor
        self.rt = rt
        self.server = ContinuousServer(engine, **server_kwargs)
        self.leader = self.server.tp is None or self.server.tp.rank == 0
        self.handle = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.host, self.port = host, port
        self._t_start = time.time()

    def start(self):
        self._t_start = time.time()
        if not self.leader:  # a follower rank: serve what rank 0 admits
            self.handle = self.server.start_online()
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr line per request
                pass

            def _json(self, code: int, obj: dict, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, "batch_slots": outer.server.b,
                                     "max_new_tokens": outer.server.max_new})
                elif self.path == "/metrics":
                    # ints written by the worker alone: a snapshot for monitoring
                    srv = outer.server
                    self._json(200, dict(srv.stats, vision_cache_entries=len(srv._vision_cache),
                                         prefix_cache_entries=len(srv._prefix_cache),
                                         uptime_s=round(time.time() - outer._t_start, 1)))
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/v1/generate":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    req = outer._build_request(body)
                except Exception as e:  # a bad body: report it, keep serving
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    if body.get("stream"):
                        outer._stream(self, req)
                        return
                    res = outer.handle.submit(req).result()
                except queue.Full:  # backlog at max_queue: back pressure
                    self._json(503, {"error": "server overloaded"}, [("Retry-After", "1")])
                    return
                self._json(500 if res.error else 200, outer._result_json(res))

        # bind before the serving worker starts: a bind failure leaks nothing
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self.handle = self.server.start_online(max_queue=self.max_queue)
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                             name="retake-http")
        self._http_thread.start()
        return self

    def _build_request(self, body: dict) -> dict:
        question = body["question"]
        path = body.get("video_path")
        # the key holds every frame-loading knob: another extraction_fps is
        # another frame set
        fps = float(body.get("extraction_fps", 25.0))
        cache_key = f"{path}|fps={fps}"
        srv = self.server
        feats = None
        if path and srv.vision_cache_slots > 0:
            feats = srv._vision_cache.get(cache_key)  # a strong reference
        if feats is None and path and srv.prefix_cache_slots > 0:
            vp = srv._prefix_cache.get(cache_key)  # a prefix carries its features
            if vp is not None:
                feats = vp.features
        if feats is not None:
            inputs = self.processor(question, video_grid=feats.grid)
            req = {k: v for k, v in inputs.items() if v is not None}
            req["video_features"] = feats
            req["video_key"] = cache_key  # the LRU bump at admission
        elif path:
            frames = fetch_video(path, self.rt.max_num_frames, self.rt.sample_fps,
                                 self.rt.longsize_resolution, extraction_fps=fps)
            inputs = self.processor(question, frames)
            req = {k: v for k, v in inputs.items() if v is not None}
            if srv.vision_cache_slots > 0 or srv.prefix_cache_slots > 0:
                req["video_key"] = cache_key
        else:
            inputs = self.processor(question)
            req = {k: v for k, v in inputs.items() if v is not None}
        if body.get("max_new_tokens") is not None:
            req["max_new_tokens"] = int(body["max_new_tokens"])
        if body.get("deadline_s") is not None:  # 0 means already expired
            req["deadline_s"] = float(body["deadline_s"])
        return req

    def _result_json(self, res) -> dict:
        return {
            "tokens": [int(t) for t in res.tokens],
            "text": self.processor.decode(res.tokens),
            "ttft_s": round(res.first_token_s - res.arrival_s, 3),
            "latency_s": round(res.finish_s - res.arrival_s, 3),
            "cancelled": bool(res.cancelled),
            **({"error": res.error} if res.error else {}),
        }

    def _stream(self, handler, req):
        """Server-sent events: the worker's ``on_tokens`` queues each chunk
        and this handler thread writes it out. A failed write sets ``dead``
        and the next ``on_tokens`` returns False: the server cancels."""
        chunks: queue.Queue = queue.Queue()
        dead = threading.Event()

        def on_tokens(rid, toks):
            chunks.put(list(toks))
            if dead.is_set():
                return False
            return None

        fut = self.handle.submit(req, on_tokens=on_tokens)  # may raise queue.Full
        fut.add_done_callback(lambda f: chunks.put(None))
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.end_headers()
        while True:
            item = chunks.get()
            if item is None:
                break
            try:
                handler.wfile.write(b"data: " + json.dumps(
                    {"tokens": item, "text_delta": self.processor.decode(item)}).encode() + b"\n\n")
                handler.wfile.flush()
            except OSError:  # broken pipe, reset: cancel at the next harvest
                dead.set()
        res = fut.result()
        try:
            handler.wfile.write(b"data: " + json.dumps(
                {"done": True, **self._result_json(res)}).encode() + b"\n\n")
            handler.wfile.flush()
        except OSError:
            pass

    def shutdown(self, timeout: Optional[float] = None):
        """Stop HTTP, then drain and join the serving loop (``timeout``
        bounds each join)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout)
            self._httpd.server_close()
            self._httpd = None
        if self.handle is not None:
            self.handle.close(timeout)
            self.handle = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
