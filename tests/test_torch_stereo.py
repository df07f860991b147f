"""legslam_torch's ops/stereo.py (torch ops) against legslam_tpu's on the
CPU, and the port mapper's monocular and stereo inactive-geometry
branches against JAX's, on the scenes of tests/test_sensor_modes.py.

* census_transform and the Hamming cost volume: bit for bit (the port
  keeps the 24-bit census in int32 and counts bits with a SWAR popcount);
* each SGM path and the aggregated cost: exact (integer-valued f32);
  sgm_disparity's integer part exact, its subpixel term within 1e-6;
* reproject_depth_pinhole, mono_borrow_depth, stereo_inactive_geo_densify
  within 1e-6;
* GaussianMapper(sensor_type="stereo" | "monocular")'s densified points
  within 1e-5 of JAX's.
"""
import jax.image
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legslam_tpu.ops import stereo as JS
from legslam_torch.ops import stereo as TS

torch.set_num_threads(1)

H, W = 96, 160
FX = FY = 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
D_TRUE = 12


@pytest.fixture(scope="module")
def pair():
    """The textured pair of tests/test_sensor_modes.py: smooth upsampled
    noise and its copy shifted by a constant disparity."""
    rng = np.random.default_rng(0)
    base = rng.uniform(size=(H, W // 8 + 8))
    left = np.asarray(jax.image.resize(base, (H, (W // 8 + 8) * 8),
                                       method="linear"))[:, :W]
    left = ((left - left.min()) / (left.max() - left.min())) \
        .astype(np.float32)
    return left, np.roll(left, -D_TRUE, axis=1).astype(np.float32)


def _kps():
    return np.stack(np.meshgrid(np.arange(48, W - 24, 8),
                                np.arange(12, H - 12, 8)), -1) \
        .reshape(-1, 2).astype(np.float32)


def test_census_and_hamming_bit_for_bit(pair):
    left, right = pair
    rng = np.random.default_rng(1)
    for img in (left, right, rng.uniform(size=(16, 24)).astype(np.float32),
                np.ones((8, 8), np.float32)):
        a = TS.census_transform(torch.as_tensor(img)).numpy()
        b = np.asarray(JS.census_transform(jnp.asarray(img)))
        assert a.dtype == np.int32 and a.max() < 1 << 24
        np.testing.assert_array_equal(a.astype(np.int64),
                                      b.astype(np.int64))
    cl, cr = (TS.census_transform(torch.as_tensor(x)) for x in pair)
    jl, jr = (JS.census_transform(jnp.asarray(x)) for x in pair)
    np.testing.assert_array_equal(
        TS._hamming_cost_volume(cl, cr, 32).numpy(),
        np.asarray(JS._hamming_cost_volume(jl, jr, 32)))


def test_popcount_matches_lax():
    x = np.random.default_rng(2).integers(0, 1 << 24, size=4096,
                                          dtype=np.int64)
    x[:3] = [0, (1 << 24) - 1, 1 << 23]
    a = TS.popcount32(torch.as_tensor(x, dtype=torch.int32)).numpy()
    b = np.asarray(jax.lax.population_count(jnp.asarray(x, jnp.uint32)))
    np.testing.assert_array_equal(a, b.astype(np.int32))


@pytest.mark.parametrize("reverse", [False, True])
def test_aggregate_path_exact(pair, reverse):
    cl, cr = (JS.census_transform(jnp.asarray(x)) for x in pair)
    cost = np.array(JS._hamming_cost_volume(cl, cr, 32))
    for c in (cost, np.swapaxes(cost, 0, 1)):
        a = TS._aggregate_dir(torch.as_tensor(np.ascontiguousarray(c)),
                              10.0, 120.0, reverse)
        b = JS._aggregate_dir(jnp.asarray(c), 10.0, 120.0, reverse)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sgm_disparity_matches(pair, num_disp=32, min_disp=2):
    left, right = pair
    a = TS.sgm_disparity(torch.as_tensor(left), torch.as_tensor(right),
                         num_disp=num_disp, min_disp=min_disp).numpy()
    b = np.asarray(JS.sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                    num_disp=num_disp, min_disp=min_disp))
    np.testing.assert_array_equal(a > 0, b > 0)
    # the integer part: the winner of the aggregated cost, which equals
    # JAX's four paths summed as JS.sgm_disparity sums them
    agg = TS.sgm_aggregate(torch.as_tensor(left), torch.as_tensor(right),
                           num_disp).numpy()
    cost = JS._hamming_cost_volume(JS.census_transform(jnp.asarray(left)),
                                   JS.census_transform(jnp.asarray(right)),
                                   num_disp)
    cost_t = jnp.swapaxes(cost, 0, 1)
    agg_j = (JS._aggregate_dir(cost, 10.0, 120.0, False) +
             JS._aggregate_dir(cost, 10.0, 120.0, True) +
             jnp.swapaxes(JS._aggregate_dir(cost_t, 10.0, 120.0, False),
                          0, 1) +
             jnp.swapaxes(JS._aggregate_dir(cost_t, 10.0, 120.0, True),
                          0, 1))
    np.testing.assert_array_equal(agg, np.asarray(agg_j))
    np.testing.assert_array_equal(agg.argmin(-1),
                                  np.asarray(jnp.argmin(agg_j, -1)))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    inner = a[8:-8, 40:-20]
    assert abs(np.median(inner[inner > 0]) - D_TRUE) < 1.0


def test_reproject_and_mono_borrow_match():
    rng = np.random.default_rng(3)
    px = rng.uniform(0, [W, H], size=(64, 2)).astype(np.float32)
    z = rng.uniform(1, 4, size=64).astype(np.float32)
    has = rng.uniform(size=64) < 0.5
    z[~has] = -1.0
    a = TS.reproject_depth_pinhole(torch.as_tensor(px), torch.as_tensor(z),
                                   FX, FY, CX, CY).numpy()
    b = np.asarray(JS.reproject_depth_pinhole(jnp.asarray(px),
                                              jnp.asarray(z), FX, FY, CX,
                                              CY))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for dist in (3.0, 15.0, 40.0):
        pa, oa = TS.mono_borrow_depth(torch.as_tensor(px), torch.as_tensor(z),
                                      torch.as_tensor(has), dist, FX, FY,
                                      CX, CY)
        pb, ob = JS.mono_borrow_depth(jnp.asarray(px), jnp.asarray(z),
                                      jnp.asarray(has), dist, FX, FY, CX, CY)
        np.testing.assert_array_equal(oa.numpy(), np.asarray(ob))
        np.testing.assert_allclose(pa.numpy(), np.asarray(pb), atol=1e-6,
                                   rtol=0)
    # the 20 px neighbour is out of a 5 px budget and inside a 25 px one
    kp = torch.tensor([[10.0, 10.0], [30.0, 10.0]])
    d, h = torch.tensor([2.0, -1.0]), torch.tensor([True, False])
    assert not bool(TS.mono_borrow_depth(kp, d, h, 5.0, FX, FY, CX, CY)[1][1])
    assert bool(TS.mono_borrow_depth(kp, d, h, 25.0, FX, FY, CX, CY)[1][1])


def test_stereo_densify_matches(pair):
    left, right = pair
    rgb_l = np.repeat(left[..., None], 3, -1)
    rgb_r = np.repeat(right[..., None], 3, -1)
    kps = _kps()
    a = TS.stereo_inactive_geo_densify(
        torch.as_tensor(rgb_l), torch.as_tensor(rgb_r), torch.as_tensor(kps),
        FX, FY, CX, CY, 0.1, num_disp=32, min_disp=2)
    b = JS.stereo_inactive_geo_densify(
        jnp.asarray(rgb_l), jnp.asarray(rgb_r), jnp.asarray(kps),
        FX, FY, CX, CY, 0.1, num_disp=32, min_disp=2)
    np.testing.assert_array_equal(a[2].numpy(), np.asarray(b[2]))
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                   rtol=0)
    ok = a[2].numpy()
    assert ok.sum() > 0.7 * len(kps)
    z = a[0].numpy()[ok, 2]
    assert abs(np.median(z) - FX * 0.1 / D_TRUE) < 0.15 * FX * 0.1 / D_TRUE


def _densified(pkg, sensor, pkt_kw, mp_kw, intr):
    """The points the mapper of `pkg` caches from one keyframe packet."""
    if pkg == "jax":
        from legslam_tpu.config import MapperParams
        from legslam_tpu.mapper.mapper import GaussianMapper
        from legslam_tpu.slam.interface import KeyframePacket, OperationQueue
        extra = {}
    else:
        from legslam_torch.config import MapperParams
        from legslam_torch.mapper.mapper import GaussianMapper
        from legslam_torch.slam.interface import (KeyframePacket,
                                                  OperationQueue)
        extra = dict(device="cpu")
    m = GaussianMapper(OperationQueue(), intr, capacity=1 << 10,
                       sensor_type=sensor, mp=MapperParams(**mp_kw), **extra)
    m._ingest_keyframe(KeyframePacket(
        fid=0, timestamp=0.0, R=np.eye(3, dtype=np.float32),
        t=np.zeros(3, np.float32), depth=None, lf_image=None, **pkt_kw))
    # no store yet: the batch stays in the depth cache
    assert len(m._depth_cache) == 1 and not m._pending_points
    return m._depth_cache[0][:2]


def test_mapper_stereo_branch_matches(pair):
    left, right = pair
    kps = _kps()
    intr = dict(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                stereo_baseline=0.1)
    pkt = dict(color=np.repeat(left[..., None], 3, -1),
               color_right=np.repeat(right[..., None], 3, -1),
               kp_pixels=kps,
               kp_points_local=np.full((len(kps), 3), -1, np.float32))
    mp = dict(depth_cache=1, min_num_inactive_geo_densify=5,
              stereo_num_disparity=32, stereo_min_disparity=2)
    (pa, ca), (pb, cb) = (_densified(k, "stereo", pkt, mp, intr)
                          for k in ("torch", "jax"))
    np.testing.assert_allclose(pa, pb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ca, cb, atol=1e-5, rtol=0)
    assert abs(np.median(pa[:, 2]) - FX * 0.1 / D_TRUE) < \
        0.3 * FX * 0.1 / D_TRUE


def test_mapper_mono_branch_matches():
    intr = dict(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY)
    kps, local = [], []
    for i in range(20):
        x, y = 20 + 6 * i, 40.0
        kps += [[x, y], [x + 2, y]]
        z = 2.0 + 0.05 * i
        local += [[(x - CX) / FX * z, (y - CY) / FY * z, z], [-1, -1, -1]]
    color = np.random.default_rng(4).uniform(size=(H, W, 3)) \
        .astype(np.float32)
    pkt = dict(color=color, kp_pixels=np.asarray(kps, np.float32),
               kp_points_local=np.asarray(local, np.float32))
    mp = dict(depth_cache=1, min_num_inactive_geo_densify=2,
              mono_max_pixel_dist=3.0)
    (pa, ca), (pb, cb) = (_densified(k, "monocular", pkt, mp, intr)
                          for k in ("torch", "jax"))
    assert len(pa) == 20
    np.testing.assert_allclose(pa, pb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ca, cb, atol=1e-5, rtol=0)
