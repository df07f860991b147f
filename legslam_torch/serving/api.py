"""Serving API: /health, /find_objects, /run_legs_slam.

Counterpart of legslam_tpu/serving/api.py, with endpoint parity with
eval/find_objects_api.py:136-230. Runs under FastAPI when available;
otherwise a stdlib http.server with the same routes and JSON contracts,
so the service works in minimal images. The query's text encoder (a
callable the caller passes) and /run_legs_slam's mapper run on the
state's device, "cuda" unless the caller asks for the CPU.

  GET  /            -> {"service": ..., "endpoints": [...]}
  GET  /health      -> {"status": "ok"}
  POST /find_objects    {"query": str, "ply_path"?: str, "top_k"?: int}
       -> {"objects": [{"center": [x,y,z], "n_gaussians": int,
                        "score": float}], "query": str}
  POST /run_legs_slam   {"dataset_path": str, "output_path"?: str,
                         "max_frames"?: int}
       -> {"status": "completed", "metrics": {...},
           "kernel_launches": {kernel: launches while the request ran}}
       (1h timeout like the reference's subprocess guard,
       eval/find_objects_api.py:204-229)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import traceback
from contextlib import contextmanager
from typing import Optional

import numpy as np

from legslam_torch.utils import runtime

RUN_TIMEOUT_S = 3600
_requests = itertools.count()


class ServiceState:
    """Preloaded models + map (the reference preloads at startup,
    eval/find_objects_api.py:69-81)."""

    def __init__(self, ply_path: Optional[str] = None,
                 text_encoder=None, device: str = "cuda"):
        self.ply_path = ply_path
        # callable: [str] -> [N, 64] (array or tensor)
        self.text_encoder = text_encoder
        self.device = device
        self._map = None
        self._lock = threading.Lock()

    @runtime.spanned("query.map")
    def gaussians(self, ply_path: Optional[str] = None):
        from legslam_torch.utils.ply import load_gaussian_ply
        path = ply_path or self.ply_path
        if path is None:
            raise ValueError("no PLY configured or provided")
        with self._lock:
            if self._map is None or self._map[0] != path:
                self._map = (path, load_gaussian_ply(path))
        return self._map[1]


def handle_find_objects(state: ServiceState, payload: dict) -> dict:
    from legslam_torch.eval_harness.find_objects import (
        find_objects_in_gaussians, to_host)
    g = state.gaussians(payload.get("ply_path"))
    if "text_emb" in payload:
        # precomputed [64] embedding (the CLI's --text-emb route): works
        # on servers without converted encoder weights
        query = payload.get("query", "<precomputed>")
        text_emb = np.asarray(payload["text_emb"], np.float32).reshape(-1)
    else:
        query = payload["query"]
        if state.text_encoder is None:
            raise ValueError("text encoder not configured on the server")
        with runtime.span("query.embed"):
            text_emb = to_host(state.text_encoder([query]))[0]
    with runtime.span("query.search"):
        dets = find_objects_in_gaussians(g["xyz"], g["lang_feat"], text_emb)
    top_k = int(payload.get("top_k", 5))
    return dict(query=query, objects=[
        dict(center=[float(x) for x in d.center],
             n_gaussians=d.n_gaussians, score=d.score)
        for d in dets[:top_k]])


def kernel_launches() -> dict:
    """The CUDA kernels' launch counts in this process, by kernel name
    (each wrapper counts the launches of its own kernel)."""
    from legslam_torch.ops.cuda import composite, composite_bwd, sort
    return dict(composite_fwd=composite.composite_forward.launches,
                composite_bwd=composite_bwd.composite_backward.launches,
                sort_keys=sort.sort_keys.launches,
                sort_kv=sort.sort_kv.launches)


def handle_run_legs_slam(state: ServiceState, payload: dict) -> dict:
    from legslam_torch.eval_harness.replica_eval import run_scene
    dataset = payload["dataset_path"]
    out = payload.get("output_path", "./output/api_run")
    result: dict = {}
    error: list = []

    def work():
        try:
            result.update(run_scene(
                dataset, out, max_frames=payload.get("max_frames"),
                device=state.device))
        except Exception as e:  # noqa: BLE001
            error.append(f"{type(e).__name__}: {e}")

    before = kernel_launches()
    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout=RUN_TIMEOUT_S)
    if t.is_alive():
        return dict(status="timeout", timeout_s=RUN_TIMEOUT_S)
    if error:
        return dict(status="error", error=error[0])
    launches = {k: n - before[k] for k, n in kernel_launches().items()}
    return dict(status="completed", metrics=result,
                kernel_launches=launches)


ROUTES = {
    ("GET", "/"): lambda s, p: dict(
        service="legslam_torch", endpoints=["/health", "/find_objects",
                                          "/run_legs_slam"]),
    ("GET", "/health"): lambda s, p: dict(status="ok"),
    ("POST", "/find_objects"): handle_find_objects,
    ("POST", "/run_legs_slam"): handle_run_legs_slam,
}


@contextmanager
def request_span(route: str):
    """The "request" span of one request to `route`, a root numbered in
    arrival order: the stdlib server's handler and the FastAPI handlers
    each run a request inside one. Yields the span, whose reply status
    (200) the handler sets when it answers otherwise."""
    with runtime.span("request", request=next(_requests), route=route,
                      status=200) as sp:
        yield sp


def make_fastapi_app(state: Optional[ServiceState] = None):
    """FastAPI app (preferred runtime when fastapi is installed)."""
    from fastapi import FastAPI, HTTPException

    state = state or ServiceState()
    app = FastAPI(title="legslam_torch")

    @app.get("/")
    def root():
        with request_span("/"):
            return ROUTES[("GET", "/")](state, {})

    @app.get("/health")
    def health():
        with request_span("/health"):
            return dict(status="ok")

    @app.post("/find_objects")
    def find_objects(payload: dict):
        with request_span("/find_objects") as sp:
            try:
                return handle_find_objects(state, payload)
            except Exception as e:  # noqa: BLE001
                sp.set(status=400)
                raise HTTPException(status_code=400, detail=str(e))

    @app.post("/run_legs_slam")
    def run_slam(payload: dict):
        with request_span("/run_legs_slam"):
            return handle_run_legs_slam(state, payload)

    return app


def serve_stdlib(state: Optional[ServiceState] = None, host: str = "0.0.0.0",
                 port: int = 8005):
    """stdlib HTTP server with the same routes (offline images)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    st = state or ServiceState()

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, body: dict):
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _reply(self, method: str) -> tuple[int, dict]:
            fn = ROUTES.get((method, self.path))
            if fn is None:
                return 404, dict(error="not found")
            payload = {}
            if method == "POST":
                n = int(self.headers.get("Content-Length", 0))
                if n:
                    payload = json.loads(self.rfile.read(n))
            try:
                return 200, fn(st, payload)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                return 400, dict(error=str(e))

        def _route(self, method: str):
            with request_span(self.path) as sp:
                code, body = self._reply(method)
                sp.set(status=code)
                self._respond(code, body)

        def do_GET(self):  # noqa: N802
            self._route("GET")

        def do_POST(self):  # noqa: N802
            self._route("POST")

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    return server


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8005)
    parser.add_argument("--ply", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    state = ServiceState(ply_path=args.ply, device=args.device)
    try:
        import uvicorn
        uvicorn.run(make_fastapi_app(state), host="0.0.0.0", port=args.port)
    except ImportError:
        print(f"fastapi/uvicorn unavailable; stdlib server on :{args.port}")
        serve_stdlib(state, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
