"""legslam_torch.serving.api: the stdlib server's routes and JSON
contracts (tests/test_eval_and_serving.py's scene, on an ephemeral port),
/find_objects giving the JAX package's objects, and /run_legs_slam on the
tiny Replica layout of tests/test_torch_app.py on the CPU."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from legslam_torch.serving import api as TA
from legslam_tpu.serving import api as JA
from tests.test_torch_app import replica_scene  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _map(tmp_path, rng):
    """tests/test_eval_and_serving.py's map: 20 gaussians anti-aligned
    with the target near (1, 0, 0) among 40 others; returns (ply path,
    target)."""
    from legslam_torch.utils import ply
    n = 60
    target = np.zeros(64, np.float32)
    target[0] = 1.0
    lf = rng.normal(size=(n, 64)).astype(np.float32)
    lf[:20] = -target * 5
    xyz = np.concatenate([
        rng.normal(scale=0.02, size=(20, 3)) + [1, 0, 0],
        rng.normal(scale=1.0, size=(40, 3))]).astype(np.float32)
    p = str(tmp_path / "pc.ply")
    ply.save_gaussian_ply(
        p, xyz, np.zeros((n, 1, 3), np.float32),
        np.zeros((n, 15, 3), np.float32), lf,
        np.zeros((n, 1), np.float32), np.zeros((n, 3), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))
    return p, target


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


def test_stdlib_api(tmp_path):
    """GET /, /health; POST /find_objects by "query" through a text
    encoder that returns a tensor, and by "text_emb"; an unknown route is
    404 and a query without an encoder 400."""
    p, target = _map(tmp_path, np.random.default_rng(0))
    state = TA.ServiceState(
        ply_path=p, device="cpu",
        text_encoder=lambda qs: torch.as_tensor(target)[None].repeat(
            len(qs), 1))
    server = TA.serve_stdlib(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/health", timeout=5) as r:
            assert json.load(r) == {"status": "ok"}
        with urllib.request.urlopen(url + "/", timeout=5) as r:
            root = json.load(r)
        assert root["service"] == "legslam_torch"
        assert root["endpoints"] == ["/health", "/find_objects",
                                     "/run_legs_slam"]
        body = _post(url + "/find_objects", {"query": "a red chair"})
        assert body["query"] == "a red chair"
        assert len(body["objects"]) >= 1
        obj = body["objects"][0]
        assert sorted(obj) == ["center", "n_gaussians", "score"]
        assert abs(obj["center"][0] - 1.0) < 0.2
        by_emb = _post(url + "/find_objects",
                       {"text_emb": target.tolist(), "top_k": 1})
        assert by_emb["query"] == "<precomputed>"
        assert by_emb["objects"] == body["objects"][:1]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nope", timeout=5)
        assert e.value.code == 404
        state.text_encoder = None
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/find_objects", {"query": "x"})
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_handle_find_objects_matches_jax(tmp_path):
    """The same payloads through both packages' handler: the same JSON."""
    p, target = _map(tmp_path, np.random.default_rng(1))
    enc = (lambda qs: np.repeat(target[None], len(qs), 0))
    for payload in ({"query": "chair"}, {"query": "chair", "top_k": 1},
                    {"text_emb": (-target).tolist(), "ply_path": p}):
        got = TA.handle_find_objects(
            TA.ServiceState(ply_path=p, text_encoder=enc, device="cpu"),
            payload)
        want = JA.handle_find_objects(
            JA.ServiceState(ply_path=p, text_encoder=enc), payload)
        assert json.dumps(got) == json.dumps(want)


def test_handle_run_legs_slam(replica_scene, tmp_path,  # noqa: F811
                              monkeypatch):
    """/run_legs_slam's handler runs the port's Replica harness on the
    state's device (the CPU here) and returns its metrics; a missing
    dataset comes back as an error, not an exception. The harness runs
    with a small store and a short tail (capacity 4096, densification
    interval 5) so the CPU takes seconds, not a minute."""
    from legslam_torch import config as C
    from legslam_torch.eval_harness import replica_eval
    seen = []
    run_scene = replica_eval.run_scene

    def small_run_scene(*a, **k):
        seen.append(k)
        return run_scene(
            *a, capacity=4096,
            opt=C.OptimizationParams(densify_from_iter=1000,
                                     densification_interval=5),
            cfg=C.RasterizeConfig(max_span_x=3, max_span_y=8, chunk=64,
                                  tile_batch=4), **k)
    monkeypatch.setattr(replica_eval, "run_scene", small_run_scene)
    state = TA.ServiceState(device="cpu")
    res = TA.handle_run_legs_slam(state, {
        "dataset_path": str(replica_scene),
        "output_path": str(tmp_path / "out"), "max_frames": 4})
    assert res["status"] == "completed", res
    m = res["metrics"]
    assert m["frames"] == 4 and m["scene"] == replica_scene.name
    assert np.isfinite(m["psnr"]) and m["n_gaussians"] > 0
    assert seen[0]["device"] == "cpu"
    json.dumps(res)
    bad = TA.handle_run_legs_slam(state, {
        "dataset_path": str(tmp_path / "missing")})
    assert bad["status"] == "error"
