"""HTTP front end over the continuous-batching engine (counterpart of
``pt2tpu.serve.server``).

Standard library only: a ``ThreadingHTTPServer`` takes requests while one
driver thread advances the ``ServeEngine``; handlers only queue requests and
wait for their completion flags. The driver thread enters
``torch.inference_mode()`` itself (the mode is per thread).

API:
  POST /generate  {"prompt_ids": [...], "max_new": N, "eos_id": optional,
                   "temperature": 0.0, "top_k": 0, "top_p": 1.0}
                  -> {"ids": [...], "uid": n}
  GET  /health    -> {"status": "ok", "stats": {...}, "queue": n}
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .engine import ServeEngine
from .sampling import SamplingConfig

__all__ = ["ServingServer"]


class ServingServer:
    def __init__(
        self,
        cfg,
        params,
        host: str = "127.0.0.1",
        port: int = 8471,
        max_batch: int = 8,
        max_len: int = 2048,
        kv_quant: bool = False,
        impl: str = "auto",
        engine: Optional[ServeEngine] = None,
        decode_quantum: int = 1,
        seed: int = 0,
    ):
        self.engine = engine or ServeEngine(
            cfg, params, max_batch=max_batch, max_len=max_len, kv_quant=kv_quant, impl=impl,
            decode_quantum=decode_quantum, seed=seed,
        )
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None  # what stopped the driver, if anything
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok" if server.error is None else "failed",
                                     "stats": server.engine.stats,
                                     "queue": len(server.engine.queue)})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    ids = np.asarray(req["prompt_ids"], np.int32).reshape(-1)
                    if ids.size == 0:
                        raise ValueError("empty prompt_ids")
                    max_new = int(req.get("max_new", 64))
                    eos = req.get("eos_id")
                    eos = None if eos is None else int(eos)
                    sc = None
                    temp = float(req.get("temperature", 0.0))
                    if temp > 0.0:
                        sc = SamplingConfig(temperature=temp, top_k=int(req.get("top_k", 0)),
                                            top_p=float(req.get("top_p", 1.0)))
                    timeout = float(req.get("timeout_s", 600))
                except (KeyError, ValueError, TypeError, AttributeError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                r = server.engine.submit(ids, max_new, eos_id=eos, sampling=sc)
                deadline = time.time() + timeout
                while not r.done and time.time() < deadline and server.error is None:
                    time.sleep(0.002)
                if not r.done:
                    what = "timeout" if server.error is None else f"engine failed: {server.error}"
                    return self._json(504 if server.error is None else 500,
                                      {"error": what, "uid": r.uid})
                self._json(200, {"ids": r.out, "uid": r.uid})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def _drive(self):
        with torch.inference_mode():
            try:
                while not self._stop.is_set():
                    if not self.engine.step():
                        time.sleep(0.003)
            except BaseException as e:  # the handlers report it; nothing carries on
                self.error = e
                raise

    def start(self) -> "ServingServer":
        self._driver = threading.Thread(target=self._drive, daemon=True)
        self._driver.start()
        self._http_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._driver:
            self._driver.join(timeout=30)
