"""The ray setup (ops/ray_setup.py, the kernel KR on the card) on the CPU.

``engine.blocked.block_rays`` is declared once as a kernel wrapper; off the
card it runs ``block_rays_plain``, the plain torch version, whose rays
equal those of the engine's own functions (the scene-frame directions of
``camera.ray_directions``, the block layout of ``to_blocks``, the shell
chords of ``geometry.ray_sphere``) in every case the callers use: image
directions or not, a chord bound from the max map, a cached one or none,
a strip of a taller frame. The burst's plain version builds its rays
without the wrapper. The kernel itself is held to the plain version bit
for bit on the card (tests/test_torch_gpu.py).
"""

from datetime import datetime, timezone

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one CPU thread, as the other port tests)
from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.synth import synthesize_moon
from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.engine.camera import ray_directions
from moonrtx_tpu_torch.engine.geometry import mat3t_apply, ray_sphere
from moonrtx_tpu_torch.engine.scene import MoonScene
from moonrtx_tpu_torch.ops import ray_setup
from moonrtx_tpu_torch.types import Observer
from moonrtx_tpu_torch.utils import profiling

DT0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)


@pytest.fixture(scope="module")
def scene():
    elev, albedo = synthesize_moon(180, 360, seed=5, n_craters=60)
    rs = float(elev.max())
    cfg = RenderConfig(observer=Observer(50.06, 19.94, 219), dt_local=DT0,
                       width=128, height=96, shadow_accuracy=4).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                  device="cpu")
    s.update_view()
    return s


def _call(s, bound: str, image_dirs: bool, strip: bool):
    """block_rays' arguments on the scene's view: the chord bound from the
    max map, a cached one or none; a 32-row strip at row 40 of the frame,
    or the whole frame."""
    height, extra = s.height, {}
    if strip:
        height, extra = 32, dict(row_offset=40, full_height=s.height)
    call = dict(basis=s.render_basis(), rotation=s._fp.rotation,
                jitter=torch.tensor([0.31, -0.27]), height=height,
                width=s.width, h_min=s.h_min, image_dirs=image_dirs, **extra)
    if bound == "maxmap":
        call["maxmap"] = s.maxmap
    elif bound == "cached":
        call["h_bound"] = ray_setup.block_rays_plain(
            **dict(call, maxmap=s.maxmap)).h_bound
    return call


CASES = [(bound, image_dirs, strip)
         for bound in ("maxmap", "cached", "none")
         for image_dirs in (True, False) for strip in (False, True)]


def test_ray_setup_is_declared_once():
    k = kernels.registered()["block_rays"]
    assert k.wrapper is ray_setup.block_rays
    assert k.plain is ray_setup.block_rays_plain
    assert (k.source, k.entry, k.passes) == ("ray_setup", "mrtx_ray_setup",
                                             ("ray_setup_kernel",))
    assert k.replaces == ("none: jnp code XLA fuses "
                          "(moonrtx_tpu/engine/blocked.py:199 block_rays)")
    assert "launch.block_rays" in profiling.counters()


@pytest.mark.parametrize("bound,image_dirs,strip", CASES)
def test_block_rays_off_the_card_is_the_plain_version(scene, monkeypatch,
                                                      bound, image_dirs,
                                                      strip):
    call = _call(scene, bound, image_dirs, strip)
    ran = []
    real = ray_setup.block_rays_plain

    def spy(*a, **k):
        ran.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ray_setup, "block_rays_plain", spy)
    n0 = kernels.launch_counts()["block_rays"]
    got = blocked.block_rays(**call)
    assert ran == [1] and kernels.launch_counts()["block_rays"] == n0
    ref = real(**call)
    for name, t in got._asdict().items():
        r = getattr(ref, name)
        assert (t is None) == (r is None), name
        if t is not None:
            assert t.dtype == r.dtype and torch.equal(t, r), name
    nblk = (call["height"] // 8) * (call["width"] // 16)
    assert got.db.shape == (nblk, 128, 3) and got.ob.shape == (3,)
    assert got.t_enter.shape == got.t_end.shape == (nblk, 128)
    assert got.hit_outer.dtype == torch.bool
    assert (got.dirs_scene is not None) == image_dirs
    assert (got.h_bound is None) == (bound == "none")
    if bound == "cached":
        assert got.h_bound is call["h_bound"]


@pytest.mark.parametrize("strip", [False, True])
def test_plain_rays_are_the_engine_rays(scene, strip):
    """The rays in block layout are camera.ray_directions' rotated into
    the body frame; without a bound the live rays' chords are the shells'
    own; the rays without a chord sit at their block's mean entry (0 in a
    block without a live ray); the strip's rays are the frame's rows."""
    s = scene
    call = _call(s, "none", True, strip)
    geom = ray_setup.block_rays_plain(**call)
    dirs = ray_directions(call["basis"], call["height"], call["width"],
                          call["jitter"], row_offset=call.get("row_offset", 0),
                          full_height=call.get("full_height"))
    assert torch.equal(geom.dirs_scene, dirs)
    db = mat3t_apply(s._fp.rotation, blocked.to_blocks(dirs))
    assert torch.equal(geom.db, db)
    ob = mat3t_apply(s._fp.rotation, call["basis"].eye)
    assert torch.equal(geom.ob, ob)
    hit, t0, t1 = ray_sphere(ob, db, C.MOON_RADIUS)
    assert torch.equal(geom.hit_outer, hit)
    live = geom.hit_outer
    assert torch.equal(geom.t_enter[live], torch.clamp(t0, min=0.0)[live])
    assert bool((geom.t_end[live] <= t1[live]).all())
    n_live = live.sum(dim=1)
    mean = torch.where(live, geom.t_enter, 0.0).sum(dim=1) / n_live.clamp(
        min=1)
    dead = ~live
    want = torch.where(n_live > 0, mean, 0.0)[:, None].expand_as(dead)
    assert torch.allclose(geom.t_enter[dead], want[dead], rtol=1e-6)
    assert torch.equal(geom.t_enter[dead], geom.t_end[dead])
    assert bool((n_live == 0).any()) and bool((n_live == 128).any())
    assert bool(((n_live > 0) & (n_live < 128)).any())
    if strip:
        full = ray_setup.block_rays_plain(**_call(s, "none", True, False))
        assert torch.equal(geom.dirs_scene, full.dirs_scene[40:72])


def test_block_dirs_equal_the_image_dirs(scene):
    """image_dirs=False builds the same directions in block layout."""
    for strip in (False, True):
        with_dirs = ray_setup.block_rays_plain(
            **_call(scene, "maxmap", True, strip))
        without = ray_setup.block_rays_plain(
            **_call(scene, "maxmap", False, strip))
        for name in ("db", "t_enter", "t_end", "hit_outer", "h_bound"):
            assert torch.equal(getattr(with_dirs, name),
                               getattr(without, name)), name


def test_the_bound_tightens_the_chords(scene):
    free = ray_setup.block_rays_plain(**_call(scene, "none", True, False))
    bound = ray_setup.block_rays_plain(**_call(scene, "maxmap", True, False))
    assert bound.h_bound.shape == (free.db.shape[0],)
    both = free.hit_outer & bound.hit_outer
    assert bool(both.any())
    assert bool((bound.t_enter[both] >= free.t_enter[both]).all())
    assert bool((bound.t_end[both] <= free.t_end[both]).all())
    assert not bool((bound.hit_outer & ~free.hit_outer).any())


def test_fractions_are_torch_linspace():
    want = torch.linspace(0.0, 1.0, ray_setup.N_FRAC,
                          dtype=torch.float32).tolist()
    assert ray_setup.FRACTIONS == want


def test_wrapper_refuses_a_frame_of_partial_blocks(scene):
    with pytest.raises(ValueError, match="8x16-pixel blocks"):
        ray_setup.block_rays(**dict(_call(scene, "none", True, False),
                                    height=92))
