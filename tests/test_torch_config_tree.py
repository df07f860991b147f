"""The port's config loaders (legslam_torch/config.py) on the shipped cfg/
tree, against legslam_tpu's: every YAML under cfg/ through
load_opencv_yaml, optimization_from_yaml, mapper_params_from_yaml and
(for camera files) intrinsics_from_yaml, field by field and exactly
(dist_coeffs, depth_scale and the stereo baseline included);
load_run_config on each shipped mapper / camera pair; and the value
checks of tests/test_config_tree.py run on the port.
"""
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from legslam_tpu import config as JC
from legslam_torch import config as TC
from legslam_torch.config import (
    MapperParams,
    OptimizationParams,
    intrinsics_from_yaml,
    load_opencv_yaml,
    load_run_config,
    mapper_params_from_yaml,
    optimization_from_yaml,
)

CFG = Path(__file__).resolve().parent.parent / "cfg"
YAMLS = sorted(str(p.relative_to(CFG)) for p in CFG.rglob("*.yaml"))

# each shipped mapper config beside the camera it runs with
PAIRS = [
    *[(f"gaussian_mapper/RGB-D/Replica/{s}.yaml",
       f"camera/RGB-D/Replica/{s}.yaml")
      for s in ("office0", "office1", "office2", "office3", "office4",
                "room0", "room1", "room2")],
    ("gaussian_mapper/RGB-D/Replica/replica_rgbd.yaml",
     "camera/RGB-D/Replica/office0.yaml"),
    ("gaussian_mapper/RGB-D/ScanNet/scannet.yaml",
     "camera/RGB-D/ScanNet/scannet.yaml"),
    *[(f"gaussian_mapper/RGB-D/TUM/{s}.yaml", f"camera/RGB-D/TUM/{s}.yaml")
      for s in ("tum_freiburg1_desk", "tum_freiburg2_xyz",
                "tum_freiburg3_long_office_household")],
    ("gaussian_mapper/RGB-D/TUM/tum_rgbd.yaml",
     "camera/RGB-D/TUM/tum_freiburg1_desk.yaml"),
    ("gaussian_mapper/Monocular/replica_mono.yaml",
     "camera/Monocular/Replica/replica_mono.yaml"),
    ("gaussian_mapper/Stereo/euroc_stereo.yaml", "camera/Stereo/euroc.yaml"),
]


def assert_same_value(a, b, what):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_same_dict(a: dict, b: dict, what):
    assert list(a) == list(b), what
    for k in b:
        assert_same_value(a[k], b[k], f"{what}: {k}")


def assert_same_params(a, b, what):
    assert type(a).__name__ == type(b).__name__
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert_same_dict(fa, fb, what)


def test_every_shipped_yaml_is_covered():
    assert len(YAMLS) == 32
    cams = {c for _, c in PAIRS}
    assert all(os.path.exists(CFG / m) for m, _ in PAIRS)
    assert all(os.path.exists(CFG / c) for c in cams)


@pytest.mark.parametrize("name", YAMLS)
def test_loaders_match_jax(name):
    path = str(CFG / name)
    d, dj = load_opencv_yaml(path), JC.load_opencv_yaml(path)
    assert d, name
    assert_same_dict(d, dj, name)
    assert_same_params(optimization_from_yaml(d),
                       JC.optimization_from_yaml(dj), name)
    assert_same_params(mapper_params_from_yaml(d),
                       JC.mapper_params_from_yaml(dj), name)
    if "Camera1.fx" in dj:
        intr, intr_j = intrinsics_from_yaml(d), JC.intrinsics_from_yaml(dj)
        assert_same_dict(intr, intr_j, name)
    else:
        with pytest.raises(KeyError):
            JC.intrinsics_from_yaml(dj)
        with pytest.raises(KeyError):
            intrinsics_from_yaml(d)


@pytest.mark.parametrize("mapper_yaml,camera_yaml", PAIRS)
def test_load_run_config_matches_jax(mapper_yaml, camera_yaml):
    m, c = str(CFG / mapper_yaml), str(CFG / camera_yaml)
    opt, mp, intr = load_run_config(m, c)
    opt_j, mp_j, intr_j = JC.load_run_config(m, c)
    assert isinstance(opt, TC.OptimizationParams)
    assert isinstance(mp, TC.MapperParams)
    assert_same_params(opt, opt_j, mapper_yaml)
    assert_same_params(mp, mp_j, mapper_yaml)
    assert_same_dict(intr, intr_j, camera_yaml)
    opt, mp, intr = load_run_config(m)
    assert intr is None and JC.load_run_config(m)[2] is None


# --- the value checks of tests/test_config_tree.py, on the port ------------

def test_replica_scene_yaml_values():
    d = load_opencv_yaml(
        str(CFG / "gaussian_mapper/RGB-D/Replica/office0.yaml"))
    opt = optimization_from_yaml(d)
    assert opt.iterations == 30100
    assert opt.position_lr_init == 0.00032
    assert opt.position_lr_final == 0.00016  # per-scene delta
    assert opt.position_lr_max_steps == 24
    assert opt.densify_grad_threshold == 0.001
    assert opt.densify_from_iter == 600
    assert opt.opacity_reset_interval == 0
    assert opt.sh_degree == 3
    # no YAML key for the LF lr: ctor default 0.0015
    # (gaussian_parameters.h:65)
    assert opt.lang_feature_lr == 0.0015

    mp = mapper_params_from_yaml(d)
    assert mp.min_num_initial_map_kfs == 10
    assert mp.new_keyframe_times_of_use == 8
    assert mp.loop_closure_increased_times_of_use == 2
    assert mp.num_gaus_pyramid_sub_levels == 3  # per-scene delta
    assert mp.gaus_pyramid_times_of_use == (8, 8, 8)
    assert mp.do_inactive_geo_densify is True
    assert mp.cull_keyframes is False
    assert mp.rgbd_max_depth == 40.0
    assert mp.position_lr_max_steps_slam == 24


def test_scannet_and_tum_deltas():
    d = load_opencv_yaml(
        str(CFG / "gaussian_mapper/RGB-D/ScanNet/scannet.yaml"))
    opt = optimization_from_yaml(d)
    mp = mapper_params_from_yaml(d)
    assert opt.iterations == 50100
    assert opt.percent_dense == 0.005
    assert opt.opacity_reset_interval == 5000
    assert mp.depth_cache == 20
    assert mp.new_keyframe_times_of_use == 16
    assert mp.gaus_pyramid_times_of_use == (16, 16)

    d = load_opencv_yaml(
        str(CFG / "gaussian_mapper/RGB-D/TUM/tum_rgbd.yaml"))
    mp = mapper_params_from_yaml(d)
    assert mp.new_keyframe_times_of_use == 2
    assert mp.large_rot_th == 30.0
    assert mp.large_trans_th == 1.0


def test_camera_yaml_intrinsics():
    from legslam_torch.utils.undistort import build_undistortion
    d = load_opencv_yaml(
        str(CFG / "camera/RGB-D/TUM/tum_freiburg1_desk.yaml"))
    intr = intrinsics_from_yaml(d)
    assert intr["width"] == 640 and intr["height"] == 480
    np.testing.assert_allclose(intr["fx"], 517.306408)
    assert intr["depth_scale"] == 5000.0
    # fr1 has strong distortion -> coeffs present and the undistortion
    # machinery engages
    assert "dist_coeffs" in intr and intr["dist_coeffs"][0] != 0.0
    assert build_undistortion(intr) is not None

    d = load_opencv_yaml(str(CFG / "camera/RGB-D/Replica/office0.yaml"))
    intr = intrinsics_from_yaml(d)
    assert intr["fx"] == 600.0 and intr["cx"] == 599.5
    assert intr["depth_scale"] == 6553.5
    assert "dist_coeffs" not in intr  # all-zero -> pinhole fast path


def test_mono_and_stereo_camera_yamls():
    d = load_opencv_yaml(
        str(CFG / "camera/Monocular/Replica/replica_mono.yaml"))
    intr = intrinsics_from_yaml(d)
    assert intr["width"] == 1200 and intr["fx"] == 600.0
    assert "depth_scale" not in intr          # monocular: no depth factor
    assert "dist_coeffs" in intr              # reference mono yaml has k1

    d = load_opencv_yaml(str(CFG / "camera/Stereo/euroc.yaml"))
    # !!opencv-matrix block parses into a [4,4] array
    T = d["Stereo.T_c1_c2"]
    assert T.shape == (4, 4) and abs(T[0, 0] - 0.999997256477797) < 1e-12
    intr = intrinsics_from_yaml(d)
    assert intr["width"] == 752 and intr["height"] == 480
    # baseline derived from ||T_c1_c2 translation|| (EuRoC ~11 cm)
    np.testing.assert_allclose(intr["stereo_baseline"], 0.110077842,
                               atol=1e-6)


def test_load_run_config_and_defaults_roundtrip():
    opt, mp, intr = load_run_config(
        str(CFG / "gaussian_mapper/RGB-D/Replica/replica_rgbd.yaml"),
        str(CFG / "camera/RGB-D/Replica/office0.yaml"))
    assert isinstance(opt, OptimizationParams)
    assert isinstance(mp, MapperParams)
    assert intr["width"] == 1200
    # missing keys keep dataclass defaults (the "flag defaults" contract)
    assert optimization_from_yaml({}) == OptimizationParams()
    assert mapper_params_from_yaml({}) == MapperParams()


def test_all_shipped_yamls_parse():
    for name in YAMLS:
        assert load_opencv_yaml(str(CFG / name)), name
    assert len(YAMLS) >= 25
