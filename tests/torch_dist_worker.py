"""The rank worker of tests/test_torch_parallel_dist.py: one mapping step,
or a short mapper run, on a gloo group of CPU processes. It imports torch
and legslam_torch only (mp.spawn re-imports this module in every rank, and
the ranks need no JAX); the test's own process runs `step` without a group
for the one-process reference."""
import numpy as np
import torch
import torch.distributed as dist

from legslam_torch.config import OptimizationParams, RasterizeConfig
from legslam_torch.mapper.train_step import train_step
from legslam_torch.models import gaussians as G
from legslam_torch.parallel import capacity, sharded, spatial
from legslam_torch.utils.camera import CameraView

W, H = 128, 88
CFG = RasterizeConfig(tile_h=16, tile_w=128, max_span_x=1, max_span_y=6,
                      chunk=32, tile_batch=2, max_pairs=1 << 14)
N_VIEWS = 4
N_STRIPS = 2


def inputs():
    """The seeded store (capacity 128), 4 views and their targets."""
    rng = np.random.default_rng(21)
    n, cap = 96, 128
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 2.0
    st = G.create_from_pcd(pts, rng.uniform(size=(n, 3)), cap,
                           lang_feat=rng.normal(size=(n, 64)), device="cpu")
    views = [CameraView.create(np.eye(3), np.zeros(3), W, H, fx=60.0 + 4 * i,
                               fy=60.0, device="cpu")
             for i in range(N_VIEWS)]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    gt = dict(gt_color=t(rng.uniform(size=(N_VIEWS, H, W, 3))),
              gt_lang_feat=t(rng.normal(size=(N_VIEWS, H, W, 64))),
              gt_depth=torch.full((N_VIEWS, H, W), 2.5),
              mask=torch.ones(N_VIEWS, H, W))
    return st, views, gt


def mapper_run(case: str, group=None):
    """A GaussianMapper over 5 frames of a 128x64 room (2 ticks a frame,
    a tail of 3) with 2 views a tick ("mapper_views") or the store
    sharded ("mapper_store"), over `group` (None: one process). Returns
    (its whole store, the last synced loss)."""
    from legslam_torch.config import MapperParams
    from legslam_torch.data.synthetic import SyntheticDataset
    from legslam_torch.mapper.mapper import GaussianMapper
    from legslam_torch.slam.trajectory import TrajectoryFrontend
    ds = SyntheticDataset(n_frames=5, width=128, height=64, n_gaussians=800,
                          seed=5, revolutions=0.2, device="cpu")
    fe = TrajectoryFrontend(ds.intrinsics, kf_stride=1, max_corners=200)
    kw = dict(n_views=2) if case == "mapper_views" else dict(shard_store=True)
    m = GaussianMapper(
        fe.queue, ds.intrinsics,
        opt=OptimizationParams(densify_from_iter=4, densification_interval=6,
                               opacity_reset_interval=0),
        mp=MapperParams(min_num_initial_map_kfs=2, depth_cache=2,
                        do_gaus_pyramid_training=False),
        cfg=RasterizeConfig(tile_h=16, tile_w=128, max_span_x=1,
                            max_span_y=4, chunk=64),
        capacity=1 << 12, max_per_tile=512, include_lang_feat=False,
        result_dir="/dev/null", device="cpu", group=group, **kw)
    m.loss_sync_interval = 1
    loss = None
    for i in range(len(ds)):
        fe.track(ds.read(i))
        m.drain_operations()
        if m.state is None and m.has_met_initial_conditions():
            m.initialize_map()
        if m.state is not None:
            for _ in range(2):
                loss = m.train_iteration()
    fe.finish()
    m.drain_operations()
    for _ in range(3):
        loss = m.train_iteration()
    return m.state, torch.tensor(loss)


def step(case: str, group=None):
    """One step of `case` over `group` (None: the one-process step).
    Returns (the whole store after the step, the aux's loss)."""
    if case.startswith("mapper"):
        return mapper_run(case, group)
    st, views, gt = inputs()
    kw = dict(active_sh_degree=0, opt=OptimizationParams(), cfg=CFG,
              max_per_tile=128)
    bg = torch.zeros(3)
    if case in ("views", "views_strips", "strips_of_views"):
        strip_group = None
        if case == "strips_of_views" and group is not None:
            # a 1 x 2 grid: every view on each rank, its strips split
            group, strip_group = spatial.make_groups(1, N_STRIPS)
        batch = sharded.shard_batch(sharded.make_view_batch(
            views, gt["gt_color"], gt["gt_lang_feat"], gt["gt_depth"],
            gt["mask"]), group)
        sharded.replicate_state(st, group)
        sharded.replicate_state(st, strip_group)
        if case == "views":
            st, aux = sharded.batched_train_step(
                st, batch, bg, 1.0, 1.0, width=W, height=H, group=group,
                **kw)
        else:
            layout = spatial.spatial_layout(H, CFG.tile_h, N_STRIPS)
            batch = batch._replace(**{
                k: torch.stack([spatial.pad_rows(x, layout.h_padded)
                                for x in getattr(batch, k)])
                for k in ("gt_color", "gt_lang_feat", "gt_depth", "mask")})
            st, aux = spatial.spatial_batched_train_step(
                st, batch, bg, 1.0, 1.0, spatial.strip_offsets(layout),
                width=W, height=H, h_local=layout.h_local, view_group=group,
                strip_group=strip_group, **kw)
        return st, aux.loss
    v = views[0]
    one = [gt[k][0] for k in ("gt_color", "gt_lang_feat", "gt_depth",
                              "mask")]
    if case == "store":
        st, aux = train_step(
            capacity.shard_state(st, group), v.world_view, v.full_proj,
            v.cam_center, v.tan_fovx, v.tan_fovy, *one, bg, 1.0, 1.0,
            width=W, height=H, gather_group=group, **kw)
        return capacity.gather_state(st, group), aux.loss
    layout = spatial.spatial_layout(H, CFG.tile_h, N_STRIPS)
    pads = [spatial.pad_rows(x, layout.h_padded) for x in one]
    shard = case == "strips_store"
    st, aux = spatial.spatial_train_step(
        capacity.shard_state(st, group) if shard else st, v.world_view,
        v.full_proj, v.cam_center, v.tan_fovx, v.tan_fovy, *pads, bg, 1.0,
        1.0, spatial.strip_offsets(layout), width=W, height=H,
        h_local=layout.h_local, group=group, shard_store=shard, **kw)
    if shard:
        st = capacity.gather_state(st, group)
    return st, aux.loss


def run(rank: int, world: int, init_file: str, out_dir: str, case: str):
    """mp.spawn's target: one rank's step, its whole store saved."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        st, loss = step(case, dist.group.WORLD)
        np.savez(f"{out_dir}/rank{rank}.npz", loss=loss.numpy(),
                 **{f"t{i}": x.numpy()
                    for i, x in enumerate(G.state_tensors(st))})
    finally:
        dist.destroy_process_group()
