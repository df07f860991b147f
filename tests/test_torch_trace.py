"""legslam_torch's spans (utils/runtime.py): off they keep nothing and
read no clock; on they nest per thread under their root, follow the
online loop's layers (the frame, the encoder, tracking, the drain and
ingest, each mapping iteration and its step's phases) and the server's
requests, leave the mapped store bitwise as it is, and are handed over on
torch.profiler's clock. All on the CPU, at a 128x64 camera."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from legslam_torch.config import (MapperParams, OptimizationParams,
                                  RasterizeConfig)
from legslam_torch.data.synthetic import SyntheticDataset
from legslam_torch.mapper.mapper import GaussianMapper
from legslam_torch.serving import api
from legslam_torch.slam.trajectory import TrajectoryFrontend
from legslam_torch.utils import runtime

torch.set_num_threads(1)

W, H, N_FRAMES, ITERS = 128, 64, 6, 2
# a one-block encoder, a depth-cache flush every 2 keyframes and a
# densification every 4 iterations, so each layer of the loop runs
SMALL_DINO = dict(image_size=28, patch_size=14, dim=32, depth=1, heads=2,
                  num_registers=4, pos_grid=2)
CFG_KW = dict(tile_h=16, tile_w=128, max_span_x=1, max_span_y=2, chunk=64,
              tile_batch=4, max_pairs=1 << 13, backend="cuda")
OPT_KW = dict(densify_from_iter=2, densification_interval=4,
              opacity_reset_interval=0, percent_dense=1e3)
MP_KW = dict(min_num_initial_map_kfs=2, depth_cache=2,
             min_num_inactive_geo_densify=1,
             do_gaus_pyramid_training=False)


@pytest.fixture
def tracer():
    """The tracer on for the test, then off with nothing left kept."""
    runtime.tracing(True)
    yield
    runtime.tracing(False)
    runtime.trace_export()


def _by_id(spans):
    return {s["id"]: s for s in spans}


def test_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    runtime.tracing(False)
    runtime.trace_export()

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with the tracer off")
    monkeypatch.setattr(runtime, "time", NoClock())
    first = runtime.span("frame", frame=3)
    assert first is runtime.span("map_iter")    # the one shared no-op
    with first as sp:
        sp.set(keyframe=True)
    assert runtime.spanned("encoder")(lambda x: x + 1)(1) == 2
    monkeypatch.undo()
    assert runtime.trace_export() == []


def test_nesting_and_roots(tracer):
    with runtime.span("a", frame=7):
        with runtime.span("b"):
            with runtime.span("c") as c:
                c.set(status=200)
        with runtime.span("d"):
            pass
    with runtime.span("e"):
        pass
    got = runtime.trace_export()
    s = {x["name"]: x for x in got}
    a = s["a"]
    assert [x["name"] for x in got] == ["c", "b", "d", "a", "e"]
    assert a["parent"] is None and a["root"] == a["id"]
    assert a["attrs"] == {"frame": 7}
    assert s["b"]["parent"] == s["d"]["parent"] == a["id"]
    assert s["c"]["parent"] == s["b"]["id"]
    assert {s[k]["root"] for k in "abcd"} == {a["id"]}
    assert s["c"]["attrs"] == {"status": 200}
    assert s["e"]["parent"] is None and s["e"]["root"] == s["e"]["id"]
    for x in got:
        assert x["start_ns"] <= x["end_ns"]
    assert a["start_ns"] <= s["b"]["start_ns"] <= s["c"]["start_ns"]
    assert s["c"]["end_ns"] <= s["b"]["end_ns"] <= a["end_ns"]
    assert runtime.trace_export() == []          # handed over once


def test_a_backward_on_another_thread_keeps_its_own_root(tracer):
    """Autograd runs a CUDA backward on a thread of its own: a span opened
    there while the caller's span is open is a root, not the caller's
    child, and the caller's stack is left as it was."""
    class Spanned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            with runtime.span("bwd"):
                return g * 2

    x = torch.ones(3, requires_grad=True)
    y = Spanned.apply(x).sum()
    with runtime.span("step.backward"):
        t = threading.Thread(target=y.backward)
        t.start()
        t.join()
        with runtime.span("after"):
            pass
    s = {x["name"]: x for x in runtime.trace_export()}
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    assert s["bwd"]["parent"] is None and s["bwd"]["root"] == s["bwd"]["id"]
    assert s["bwd"]["thread"] != s["step.backward"]["thread"]
    assert s["after"]["parent"] == s["step.backward"]["id"]


def test_many_threads_lose_no_span():
    """More threads than cores open nested spans at a short switch
    interval while the main thread hands spans over: every span arrives
    once, with its own id, under its own thread's parent."""
    import sys
    n_threads, n = 16, 300
    runtime.tracing(True)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with runtime.span("outer"):
                    with runtime.span("inner"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            got += runtime.trace_export()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        runtime.tracing(False)
    got += runtime.trace_export()
    assert len(got) == 2 * n * n_threads
    by_id = _by_id(got)
    assert len(by_id) == len(got)
    for s in got:
        if s["name"] == "inner":
            p = by_id[s["parent"]]
            assert p["name"] == "outer" and p["thread"] == s["thread"]
            assert s["root"] == p["id"]
        else:
            assert s["parent"] is None and s["root"] == s["id"]


def _loop(tracing_on: bool, tmp_path):
    """N_FRAMES frames through the app's process_frame with the encoder;
    returns (mapper, the spans)."""
    from legslam_torch.apps.replica_rgbd import process_frame
    from legslam_torch.models import dinov2 as D
    from legslam_torch.models import pca as PCA
    from legslam_torch.models.encoder import LanguageFeaturesEncoder
    ds = SyntheticDataset(n_frames=N_FRAMES, width=W, height=H,
                          n_gaussians=1500, seed=3, revolutions=0.2,
                          device="cpu")
    dcfg = D.DinoV2Config(**SMALL_DINO)
    dino = D.init_params(dcfg, torch.Generator().manual_seed(5),
                         device="cpu")
    # a 32 -> 64 projection: the store keeps 64 LF channels
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(64, 32)))
    pca = PCA.PCAParams(torch.zeros(32),
                        torch.as_tensor(q, dtype=torch.float32))
    encoder = LanguageFeaturesEncoder(dino, pca, dcfg, dtype=torch.float32,
                                      device="cpu")
    frontend = TrajectoryFrontend(ds.intrinsics, kf_stride=2, max_corners=200)
    mapper = GaussianMapper(
        frontend.queue, ds.intrinsics, opt=OptimizationParams(**OPT_KW),
        mp=MapperParams(**MP_KW), cfg=RasterizeConfig(**CFG_KW),
        capacity=1 << 12, max_per_tile=512, binning_refresh_interval=2,
        result_dir=str(tmp_path), seed=0, device="cpu")
    mapper.loss_sync_interval = 1
    frames = [ds.read(i) for i in range(N_FRAMES)]   # renders: no spans
    runtime.tracing(tracing_on)
    try:
        for frame in frames:
            process_frame(frame, frontend, mapper, encoder,
                          iters_per_frame=ITERS)
    finally:
        runtime.tracing(False)
    return mapper, runtime.trace_export()


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    return (_loop(True, tmp_path_factory.mktemp("on")),
            _loop(False, tmp_path_factory.mktemp("off")))


def test_process_frame_span_tree(loops):
    (mapper, spans), _ = loops
    by_id = _by_id(spans)
    frames = [s for s in spans if s["name"] == "frame"]
    assert [f["attrs"] for f in frames] == [
        dict(frame=i, keyframe=i % 2 == 0) for i in range(N_FRAMES)]
    # every span belongs to one frame: its root is that frame span
    assert {s["root"] for s in spans} == {f["id"] for f in frames}
    for s in spans:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["root"] == s["root"] and p["thread"] == s["thread"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]

    def parents(name):
        return {by_id[s["parent"]]["name"] for s in spans
                if s["name"] == name}
    for name in ("encoder", "track", "drain", "map.init", "map_iter"):
        assert parents(name) == {"frame"}, name
    assert parents("track.keypoints") == {"track"}
    assert parents("ingest.keyframe") == {"drain"}
    assert parents("ingest.flush") == {"ingest.keyframe"}
    assert parents("ingest.points") <= {"drain", "ingest.flush"}
    assert parents("ingest.points")
    for name in ("map.binning", "step.render", "step.loss", "step.backward",
                 "step.adam", "map.loss_sync", "map.densify"):
        assert parents(name) == {"map_iter"}, name
    for name in ("render.prologue", "render.pairs", "render.composite"):
        assert parents(name) == {"step.render"}, name
    count = {}
    for s in spans:
        count[s["name"]] = count.get(s["name"], 0) + 1
    assert count["encoder"] == count["track"] == count["drain"] == N_FRAMES
    assert count["track.keypoints"] == N_FRAMES // 2
    assert count["map.init"] == 1
    iters = [s for s in spans if s["name"] == "map_iter"]
    assert len(iters) == mapper.iteration == count["step.render"] == \
        count["step.adam"] == count["map.loss_sync"]
    assert [s["attrs"]["iteration"] for s in iters] == \
        list(range(1, mapper.iteration + 1))
    assert {s["attrs"]["level"] for s in iters} == {0}
    assert {s["attrs"]["keyframe"] for s in iters} <= set(mapper.keyframes)
    assert 0 < count["map.binning"] == mapper.fresh_binnings < len(iters)
    assert count["map.densify"] == len(
        [i for i in range(3, mapper.iteration + 1) if i % 4 == 0])


def test_tracing_leaves_the_store_bitwise(loops):
    (on, spans), (off, none) = loops
    assert spans and none == []
    assert on.iteration == off.iteration
    assert torch.equal(on.state.valid, off.state.valid)
    for name, t in on.state.params.as_dict().items():
        assert torch.equal(t, off.state.params.as_dict()[name]), name


def test_capacity_growth_is_a_span(loops, tracer):
    (mapper, _), _ = loops
    cap = mapper.state.capacity
    mapper.capacity = 4 * cap
    mapper._approx_valid = cap
    with runtime.span("map_iter"):
        mapper._maybe_grow_capacity()
    (grow, it) = runtime.trace_export()
    assert mapper.state.capacity == 4 * cap
    assert grow["name"] == "map.grow" and grow["parent"] == it["id"]
    assert grow["attrs"] == {"capacity": 4 * cap}


def test_profile_trace_puts_spans_on_the_profilers_clock(tmp_path):
    """trace.json of profile_trace holds the spans as a process of their
    own; one around a record_function mark holds the mark, on the mark's
    clock to 1 ms."""
    torch.ones(8) @ torch.ones(8)
    with runtime.profile_trace(str(tmp_path)) as d:
        with torch.profiler.record_function("warm"):
            torch.ones(8) @ torch.ones(8)
        with runtime.span("outer"):
            with torch.profiler.record_function("mark"):
                torch.ones(8) @ torch.ones(8)
    assert runtime.span("x") is runtime.span("y")    # off again
    with open(f"{d}/trace.json") as f:
        ev = json.load(f)["traceEvents"]
    mark = next(e for e in ev if e.get("name") == "mark" and
                e.get("ph") == "X")
    outer = next(e for e in ev if e.get("cat") == "legslam_span")
    assert outer["name"] == "outer" and outer["pid"] != mark["pid"]
    assert outer["ts"] - 1e3 <= mark["ts"]
    assert mark["ts"] + mark["dur"] <= outer["ts"] + outer["dur"] + 1e3
    names = {e["args"]["name"] for e in ev if e.get("ph") == "M" and
             e.get("name") == "process_name" and e["pid"] == outer["pid"]}
    assert names == {"legslam_torch spans"}


def _map(path, rng):
    from legslam_torch.utils import ply
    n = 60
    lf = rng.normal(size=(n, 64)).astype(np.float32)
    lf[:20] = 0.0
    lf[:20, 0] = -5.0
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[:20] = rng.normal(scale=0.02, size=(20, 3)) + [1, 0, 0]
    ply.save_gaussian_ply(
        path, xyz, np.zeros((n, 1, 3), np.float32),
        np.zeros((n, 15, 3), np.float32), lf, np.zeros((n, 1), np.float32),
        np.zeros((n, 3), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


def test_find_objects_requests(tmp_path, tracer):
    """Two /find_objects requests in flight at once on the stdlib server:
    each is a root with its own id, its query.map, query.embed and
    query.search (with search.similarity and search.cluster) under it on
    its own thread, and its self time (the request less its embedding
    and search) is what is left."""
    path = str(tmp_path / "pc.ply")
    _map(path, np.random.default_rng(0))
    both = threading.Barrier(2, timeout=10)
    target = np.zeros(64, np.float32)
    target[0] = 1.0

    def encoder(qs):
        both.wait()          # both requests are inside their spans
        return torch.as_tensor(target)[None].repeat(len(qs), 1)
    state = api.ServiceState(ply_path=path, text_encoder=encoder,
                             device="cpu")
    server = api.serve_stdlib(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}/find_objects"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = []
    try:
        clients = [threading.Thread(target=lambda q=q: replies.append(
            _post(url, {"query": q}))) for q in ("chair", "table")]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=20)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert len(replies) == 2 and all(r["objects"] for r in replies)
    spans = runtime.trace_export()
    by_id = _by_id(spans)
    requests = [s for s in spans if s["name"] == "request"]
    assert len(requests) == 2
    assert {r["root"] for r in requests} == {r["id"] for r in requests}
    assert len({r["thread"] for r in requests}) == 2
    assert len({r["attrs"]["request"] for r in requests}) == 2
    for r in requests:
        assert r["attrs"]["route"] == "/find_objects"
        assert r["attrs"]["status"] == 200
        mine = [s for s in spans if s["root"] == r["id"] and s is not r]
        for s in mine:
            assert s["thread"] == r["thread"]
        names = {s["name"]: s for s in mine}
        assert set(names) == {"query.map", "query.embed", "query.search",
                              "search.similarity", "search.cluster"}
        for name in ("query.map", "query.embed", "query.search"):
            assert names[name]["parent"] == r["id"]
        for name in ("search.similarity", "search.cluster"):
            assert by_id[names[name]["parent"]]["name"] == "query.search"
        whole = r["end_ns"] - r["start_ns"]
        self_ns = whole - sum(names[n]["end_ns"] - names[n]["start_ns"]
                              for n in ("query.embed", "query.search"))
        assert 0 < self_ns < whole
    # the two were in flight at once
    a, b = requests
    assert a["start_ns"] < b["end_ns"] and b["start_ns"] < a["end_ns"]


def test_route_status_is_an_attribute(tmp_path, tracer):
    state = api.ServiceState(ply_path=None, device="cpu")
    server = api.serve_stdlib(state, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            assert json.load(r) == {"status": "ok"}
        for path, code in (("/nope", 404), ("/find_objects", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                if path == "/nope":
                    urllib.request.urlopen(base + path, timeout=5)
                else:
                    _post(base + path, {"query": "x"})
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    got = [(s["attrs"]["route"], s["attrs"]["status"])
           for s in runtime.trace_export() if s["name"] == "request"]
    assert got == [("/health", 200), ("/nope", 404), ("/find_objects", 400)]
