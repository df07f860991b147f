"""The comparison that decides `correct`: the control (the reference in
the precision below the configuration's, in the program's place) and a
broken program each come out not correct, on a tiny CPU run. The faults
are planted underneath a whole run; the look for a card is skipped."""
from __future__ import annotations

import pytest

from conftest import run_tiny

LOOP_CELL = "replica.map15"
STREAM_CELL = "scannet.stream"


QUERY_CELL = "replica.query"


def failing(res) -> list:
    return [k for k, v in res["checks"].items() if v["value"] > v["limit"]]


def test_control_fails_a_number():
    res, _, _ = run_tiny(LOOP_CELL, control=True)
    assert not failing(res)
    from legs_bench import run
    limits = run.limits_of(LOOP_CELL)
    over = [k for k, v in res["control"].items() if v > limits[k]]
    assert over, res["control"]


def _unchanged_state(monkeypatch):
    from legslam_torch.models import gaussians as G
    monkeypatch.setattr(G, "adam_update", lambda st, *a, **k: st)


def _half_the_image(monkeypatch):
    from legslam_torch.ops import losses
    real = losses.mapping_loss

    def half(color, gt, lf, gt_lf, depth, gt_depth, mask, lam):
        h = color.shape[0] // 2
        return real(color[:h], gt[:h], None if lf is None else lf[:h],
                    None if gt_lf is None else gt_lf[:h], depth[:h],
                    gt_depth[:h], mask[:h], lam)
    monkeypatch.setattr(losses, "mapping_loss", half)


def _altered_lf(monkeypatch):
    from legslam_torch.models import encoder
    real = encoder.encode

    def altered(*a, **k):
        out = real(*a, **k)
        out[..., 0, 0, :] += 0.05 * out.abs().max()
        return out
    monkeypatch.setattr(encoder, "encode", altered)


def _altered_render(monkeypatch):
    from legslam_torch.ops import rasterize
    real = rasterize.render_arrays

    def altered(*a, **k):
        out = real(*a, **k)
        return out._replace(color=out.color * 1.01)
    monkeypatch.setattr(rasterize, "render_arrays", altered)
    from legslam_torch.mapper import train_step
    monkeypatch.setattr(train_step, "render_arrays", altered)


def _altered_keyframe(monkeypatch):
    from legslam_torch.mapper import keyframe, mapper
    real = keyframe.build_keyframe

    def altered(*a, **k):
        kf = real(*a, **k)
        kf.gt_depth[-1][0, 0] += 0.001
        return kf
    monkeypatch.setattr(mapper, "build_keyframe", altered)


def _dropped_pairs(monkeypatch):
    from legslam_torch.mapper import mapper
    real = mapper.GaussianMapper.binning_for

    def dropped(self, view, cfg):
        binning, overflow = real(self, view, cfg)
        count = binning.tile_count.clone()
        count[count.argmax()] //= 2
        return binning._replace(tile_count=count), overflow
    monkeypatch.setattr(mapper.GaussianMapper, "binning_for", dropped)


FAULTS = dict(unchanged_state=_unchanged_state,
              dropped_pairs=_dropped_pairs,
              half_the_image=_half_the_image, altered_lf=_altered_lf,
              altered_render=_altered_render,
              altered_keyframe=_altered_keyframe)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res, _, _ = run_tiny(LOOP_CELL, seconds=1.5)
    assert failing(res), res["checks"]


def _altered_answer(monkeypatch):
    from legslam_torch.eval_harness import find_objects as fo
    real = fo.find_objects_in_gaussians

    def altered(*a, **k):
        out = real(*a, **k)
        if out:
            out[0].center = out[0].center + 0.01
        return out
    monkeypatch.setattr(fo, "find_objects_in_gaussians", altered)


def _altered_embedding(monkeypatch):
    from legslam_torch.models import talk2dino
    real = talk2dino.build_text_embedding

    def altered(*a, **k):
        return real(*a, **k) * 1.001 + 1e-3
    monkeypatch.setattr(talk2dino, "build_text_embedding", altered)


def _skipped_flush(monkeypatch):
    from legslam_torch.mapper import mapper

    def skipped(self):
        self._depth_cache.clear()
        self._kfs_since_densify_flush = 0
    monkeypatch.setattr(mapper.GaussianMapper, "_flush_depth_cache",
                        skipped)


def _shifted_points(monkeypatch):
    from legslam_torch.mapper import mapper
    real = mapper.GaussianMapper._increase_points

    def shifted(self, pts, cols, smax=None):
        return real(self, pts + 0.01, cols, smax)
    monkeypatch.setattr(mapper.GaussianMapper, "_increase_points", shifted)


def _skipped_densify(monkeypatch):
    from legslam_torch.models import gaussians as G
    monkeypatch.setattr(G, "densify_and_prune", lambda st, *a, **k: st)


def _densify_drops_a_row(monkeypatch):
    from legslam_torch.models import gaussians as G
    real = G.densify_and_prune

    def drops(*a, **k):
        out = real(*a, **k)
        last = int(out.valid.nonzero().max())
        out.valid[last] = False
        return out
    monkeypatch.setattr(G, "densify_and_prune", drops)


GROWTH_FAULTS = dict(skipped_flush=_skipped_flush,
                     shifted_points=_shifted_points,
                     skipped_densify=_skipped_densify,
                     densify_drops_a_row=_densify_drops_a_row)


@pytest.mark.parametrize("fault", sorted(GROWTH_FAULTS))
def test_growth_fault_is_not_correct(fault, monkeypatch):
    """On the stream cell, whose tiny window flushes the depth cache and
    densifies several times."""
    GROWTH_FAULTS[fault](monkeypatch)
    res, _, _ = run_tiny(STREAM_CELL)
    assert failing(res), res["checks"]


QUERY_FAULTS = dict(altered_answer=_altered_answer,
                    altered_embedding=_altered_embedding)


def test_query_control_fails_a_number(card):
    """On the card only: the control's lower precision is TF32, which
    the CPU does not have."""
    res, _, _ = run_tiny(QUERY_CELL, control=True, device=card)
    assert not failing(res)
    from legs_bench import run
    limits = run.limits_of(QUERY_CELL)
    assert [k for k, v in res["control"].items() if v > limits[k]], \
        res["control"]


@pytest.mark.parametrize("fault", sorted(QUERY_FAULTS))
def test_query_fault_is_not_correct(fault, monkeypatch):
    QUERY_FAULTS[fault](monkeypatch)
    res, _, _ = run_tiny(QUERY_CELL)
    assert failing(res), res["checks"]
