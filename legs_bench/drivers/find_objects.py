"""Generator of the open-vocabulary query traffic: one client in a closed
loop asking the port's HTTP server (`legslam_torch.serving.api.
serve_stdlib`, started in a thread in set-up, on an ephemeral localhost
port) `POST /find_objects` for a category drawn uniformly by the seed.

Set-up makes, from the seed and on the device, the CLIP ViT-B/16 text
tower, the Talk2DINO projection and the PCA (as bfloat16 values of
float32 weights, held in float32), a token table standing in for the
tokenizer (each category's 7 template sequences: SOT, 3-12 word ids,
EOT), and the map: `n_cloud` gaussians with unit random language
features and one object of `n_object` gaussians per category whose
features are the negated embedding of that category (the training loss
adds the cosine, so a trained map anti-aligns), written as the PLY the
server loads, under TMPDIR. The server's text encoder embeds a query's
7 templates through `talk2dino.build_text_embedding`.

Parameters, from the traffic file: `categories`, `n_cloud`, `n_object`,
`object_radius`, `top_k`, `trace_seconds`, `trace_min_requests`,
`check_requests`.
"""
from __future__ import annotations

import contextlib
import json
import random
import shutil
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from legs_bench import tracing
from legs_bench.weights import tree_map
from legs_bench.harness import quantile
from legs_bench.reference import query as ref

SOT, EOT = 49406, 49407


def make_text_weights(seed: int, dev, c: dict) -> tuple[dict, dict, tuple]:
    """(clip text params, projection params, pca) in the port's layout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w, layers, hid = c["width"], c["layers"], 4 * c["width"]

    def randn(*shape, std=0.02):
        r = torch.randn(*shape, generator=g, device=dev) * std
        return r.to(torch.bfloat16).float()
    qkv, proj = randn(layers, w, 3 * w), randn(layers, w, w)
    fc1, fc2 = randn(layers, w, hid), randn(layers, hid, w)
    bias = randn(layers, 3 * w + w + hid + w, std=0.01)
    norms = 1.0 + randn(layers, 4, w, std=0.05)
    blocks = []
    for i in range(layers):
        b = bias[i]
        blocks.append(dict(
            ln1=dict(scale=norms[i, 0], bias=norms[i, 1] - 1.0),
            qkv=dict(kernel=qkv[i], bias=b[:3 * w]),
            proj=dict(kernel=proj[i], bias=b[3 * w:4 * w]),
            ln2=dict(scale=norms[i, 2], bias=norms[i, 3] - 1.0),
            fc1=dict(kernel=fc1[i], bias=b[4 * w:4 * w + hid]),
            fc2=dict(kernel=fc2[i], bias=b[4 * w + hid:])))
    clip = dict(token_embedding=randn(c["vocab"], w),
                pos_embedding=randn(c["context"], w, std=0.01),
                blocks=blocks,
                ln_final=dict(scale=1.0 + randn(w, std=0.05),
                              bias=randn(w, std=0.01)),
                text_projection=randn(w, c["proj_dim"]))
    clip = tree_map(clip, lambda t: t.contiguous())
    d = c["dino_dim"]
    projection = dict(linear_w=randn(c["proj_dim"], d),
                      linear_b=randn(d, std=0.01),
                      hidden_ws=[randn(d, d)], hidden_bs=[randn(d,
                                                                 std=0.01)])
    q, _ = torch.linalg.qr(torch.randn(d, c["pca_dim"], generator=g,
                                       device=dev))
    return clip, projection, (randn(d, std=0.01), q.T.contiguous())


def token_table(categories, seed: int, context: int) -> torch.Tensor:
    """[C, 7, context] int64 ids: SOT, 3-12 seeded word ids, EOT."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(categories), 7, context), np.int64)
    for c in range(len(categories)):
        for i in range(7):
            n = int(rng.integers(3, 13))
            toks[c, i, 0] = SOT
            toks[c, i, 1:n + 1] = rng.integers(1, SOT, size=n)
            toks[c, i, n + 1] = EOT
    return torch.as_tensor(toks)


def make_map(seed: int, dev, t: dict, embs: torch.Tensor) -> dict:
    """The map's raw parameters (numpy, float32): a cloud in a 6 x 6 x 7.5
    m box with unit random language features, and an object per category
    in a ball, its features the negated category embedding."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    nc, no, nk = t["n_cloud"], t["n_object"], embs.shape[0]
    n = nc + no * nk

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)
    xyz = torch.empty(n, 3, device=dev)
    xyz[:nc, :2] = rand(nc, 2) * 6.0 - 3.0
    xyz[:nc, 2] = 0.5 + rand(nc) * 7.5
    centers = torch.stack([rand(nk) * 4.0 - 2.0, rand(nk) * 4.0 - 2.0,
                           1.5 + rand(nk) * 5.0], -1)
    d = torch.randn(no * nk, 3, generator=g, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    r = t["object_radius"] * rand(no * nk, 1) ** (1.0 / 3.0)
    xyz[nc:] = centers.repeat_interleave(no, 0) + d * r
    lf = torch.randn(n, 64, generator=g, device=dev)
    lf = lf / torch.linalg.norm(lf, dim=-1, keepdim=True)
    e = embs / torch.linalg.norm(embs, dim=-1, keepdim=True)
    lf[nc:] = -e.repeat_interleave(no, 0)
    z = torch.clamp(xyz[:, 2], min=0.2)
    out = dict(
        xyz=xyz, f_dc=(rand(n, 1, 3) - 0.5) / 0.28209479177387814,
        f_rest=torch.zeros(n, 15, 3, device=dev), lang_feat=lf,
        opacity=torch.logit(0.05 + 0.9 * rand(n, 1)),
        scaling=torch.log((rand(n, 3) * 0.8 + 0.2) * (6.0 / 600.0) *
                          z[:, None]),
        rotation=torch.nn.functional.normalize(
            torch.randn(n, 4, generator=g, device=dev), dim=-1))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def write_ply(path: Path, m: dict) -> None:
    """The map in the reference's binary PLY schema: x y z nx ny nz
    f_dc_0..2 f_rest_0..44 (channel-major) lf_0..63 opacity scale_0..2
    rot_0..3, float32 little-endian."""
    n = m["xyz"].shape[0]
    rest = m["f_rest"].transpose(0, 2, 1).reshape(n, -1)
    data = np.concatenate([m["xyz"], np.zeros((n, 3), np.float32),
                           m["f_dc"].reshape(n, 3), rest, m["lang_feat"],
                           m["opacity"], m["scaling"], m["rotation"]], 1)
    names = ["x", "y", "z", "nx", "ny", "nz"] + \
        [f"f_dc_{i}" for i in range(3)] + \
        [f"f_rest_{i}" for i in range(45)] + \
        [f"lf_{i}" for i in range(64)] + ["opacity"] + \
        [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    head += [f"property float {k}" for k in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def run(ctx) -> dict:
    from legslam_torch.eval_harness import find_objects as fo
    from legslam_torch.models import clip_text as CT
    from legslam_torch.models import pca as PCA
    from legslam_torch.models import talk2dino as T2D
    from legslam_torch.serving import api
    dev, seed, t, c = ctx.device, ctx.seed, ctx.traffic, ctx.config
    tc = c["text"]
    cats = list(t["categories"])
    clip, projection, pca = make_text_weights(seed, dev, tc)
    table = token_table(cats, seed, tc["context"]).to(dev)
    ccfg = CT.ClipTextConfig(vocab=tc["vocab"], context=tc["context"],
                             width=tc["width"], layers=tc["layers"],
                             heads=tc["heads"], proj_dim=tc["proj_dim"],
                             eps=tc["eps"])
    with torch.no_grad():
        embs = torch.cat([ref.text_embedding(clip, projection, pca,
                                             table[i:i + 1], tc["heads"],
                                             tc["eps"])
                          for i in range(len(cats))])
    gmap = make_map(seed, dev, t, embs)
    tmp = Path(tempfile.mkdtemp(prefix="legs_bench_query_"))
    ply = tmp / "point_cloud.ply"
    write_ply(ply, gmap)
    proj_p = T2D.ProjectionParams(
        linear_w=projection["linear_w"], linear_b=projection["linear_b"],
        hidden_ws=tuple(projection["hidden_ws"]),
        hidden_bs=tuple(projection["hidden_bs"]))
    pca_p = PCA.PCAParams(*pca)

    def text_encoder(queries):
        idx = [cats.index(q) for q in queries]
        with torch.no_grad():
            return T2D.build_text_embedding(queries, clip, proj_p, pca_p,
                                            tokens=table[idx],
                                            clip_cfg=ccfg)

    state = api.ServiceState(ply_path=str(ply), text_encoder=text_encoder,
                             device=str(dev))
    server = api.serve_stdlib(state, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/find_objects"
    rng = random.Random(seed)
    try:
        _post(url, dict(query=cats[0], top_k=t["top_k"]))   # warm-up
        tracing.sync(dev)
        setup_s = time.time() - ctx.t_start
        res = _window(ctx, url, cats, rng, state, fo, dev)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    res["e2e"]["setup_s"] = setup_s
    res["peak"] = peak
    with torch.no_grad():
        res["checks"] = compare(res.pop("answers"), cats, clip, projection,
                                pca, table, tc, gmap, seed, t, ctx.limits)
        res["control"] = control_numbers(cats, clip, projection, pca, table,
                                         tc, gmap, t) \
            if getattr(ctx, "control", False) else None
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def _window(ctx, url, cats, rng, state, fo, dev) -> dict:
    t = ctx.traffic
    spans = tracing.Spans(dev)
    prof = None
    search = fo.find_objects_in_gaussians
    if ctx.trace:
        enc = state.text_encoder

        def spanned_enc(q):
            with spans.span("query_embed"):
                return enc(q)
        state.text_encoder = spanned_enc

        def spanned_search(*a, **k):
            with spans.span("query_search"):
                return search(*a, **k)
        fo.find_objects_in_gaussians = spanned_search
        prof = tracing.profiler()
        prof.__enter__()
    seconds = t["trace_seconds"] if ctx.trace else ctx.seconds
    min_req = t["trace_min_requests"] if ctx.trace else 1
    lat, answers, failed = [], [], 0
    t_w0 = time.perf_counter()
    try:
        while True:
            q = cats[rng.randrange(len(cats))]
            t0 = time.perf_counter()
            with (spans.span("request") if ctx.trace else
                  contextlib.nullcontext()):
                try:
                    reply = _post(url, dict(query=q, top_k=t["top_k"]))
                except (urllib.error.URLError, OSError, ValueError):
                    reply = None
            t1 = time.perf_counter()
            if reply is None or "objects" not in reply:
                failed += 1
                lat.append(float("inf"))
            else:
                lat.append((t1 - t0) * 1e3)
                answers.append((q, reply["objects"]))
            if t1 - t_w0 >= seconds and len(lat) >= min_req:
                break
    finally:
        window_s = time.perf_counter() - t_w0
        if prof is not None:
            prof.__exit__(None, None, None)
        fo.find_objects_in_gaussians = search
    e2e = dict(query_ms_p95=quantile(lat, 0.95))
    info = dict(requests=len(lat), failed=failed, window_s=window_s,
                query_ms_median=quantile(lat, 0.5))
    data = None
    if ctx.trace:
        device = tracing.reduce_trace(prof, window_s)
        data = dict(kind="query", spans=dict(spans.ms), device=device)
    return dict(attempted=len(lat), failed=failed, e2e=e2e, info=info,
                per_layer_data=data, answers=answers,
                breakdown=None if data is None else dict(
                    device_ops=device["device_ops"],
                    idle_gaps=device["idle_gaps"]))


def _numbers(got: list, want: list) -> dict:
    """Gaps of one reply's objects against the reference's, object by
    object in order: centre (m), gaussians (relative), score; a missing
    or extra object reads infinite."""
    if len(got) != len(want):
        return dict(center_gap=float("inf"), gaussians_gap=float("inf"),
                    score_gap=float("inf"))
    out = dict(center_gap=0.0, gaussians_gap=0.0, score_gap=0.0)
    for o, (center, n, score) in zip(got, want):
        out["center_gap"] = max(out["center_gap"], float(np.abs(
            np.asarray(o["center"]) - center).max()))
        out["gaussians_gap"] = max(out["gaussians_gap"],
                                   abs(o["n_gaussians"] - n) / max(n, 1))
        out["score_gap"] = max(out["score_gap"], abs(o["score"] - score))
    return out


def _ref_answers(cats, clip, projection, pca, table, tc, gmap, top_k,
                 which) -> dict:
    out = {}
    for q in which:
        i = cats.index(q)
        e = ref.text_embedding(clip, projection, pca, table[i:i + 1],
                               tc["heads"], tc["eps"])[0].cpu().numpy()
        out[q] = ref.find_objects(gmap["xyz"], gmap["lang_feat"],
                                  e)[:top_k]
    return out


def compare(answers, cats, clip, projection, pca, table, tc, gmap, seed,
            t, limits) -> dict:
    """{number: {"value", "limit"}} over a seeded sample of the window's
    replies, each against the reference's search for its query."""
    rng = random.Random(seed + 3)
    sample = rng.sample(answers, min(t["check_requests"], len(answers)))
    want = _ref_answers(cats, clip, projection, pca, table, tc, gmap,
                        t["top_k"], {q for q, _ in sample})
    nums = dict(center_gap=0.0, gaussians_gap=0.0, score_gap=0.0)
    if not sample:
        nums = {k: float("inf") for k in nums}
    for q, objs in sample:
        for k, v in _numbers(objs, want[q]).items():
            nums[k] = max(nums[k], v)
    return {k: dict(value=v, limit=limits[k]) for k, v in nums.items()}


def control_numbers(cats, clip, projection, pca, table, tc, gmap,
                    t) -> dict:
    """The control: the reference with its text tower in TF32 (the
    configuration's float32 with TF32 off), in the program's place,
    against the reference, over every category."""
    want = _ref_answers(cats, clip, projection, pca, table, tc, gmap,
                        t["top_k"], cats)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        low = _ref_answers(cats, clip, projection, pca, table, tc, gmap,
                           t["top_k"], cats)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    nums = dict(center_gap=0.0, gaussians_gap=0.0, score_gap=0.0)
    for q in cats:
        got = [dict(center=c.tolist(), n_gaussians=n, score=s)
               for c, n, s in low[q]]
        for k, v in _numbers(got, want[q]).items():
            nums[k] = max(nums[k], v)
    return nums
