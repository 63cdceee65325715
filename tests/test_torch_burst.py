"""The march path's accumulation burst on the CPU: samples 1..N-1 of
``engine/blocked.py::_burst_core`` go through one
``ops/march_shade.py::march_burst`` call, which off the card runs
``march_burst_plain``.

The burst gives the frame of the per-sample loop it replaced (one
``march_shade`` a sample and the running mean in torch, copied below)
bit for bit; the counter ``burst.fused_samples`` adds N-1 a burst; a
one-sample burst never reaches ``march_burst``. The burst kernel itself
is held to ``march_burst_plain`` on the card (tests/test_torch_gpu.py).
"""

from datetime import datetime, timezone

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one CPU thread, as the other port tests)
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.synth import synthesize_moon
from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.engine.geometry import mat3t_apply
from moonrtx_tpu_torch.engine.scene import MoonScene
from moonrtx_tpu_torch.ops import march_shade as mk
from moonrtx_tpu_torch.types import Observer
from moonrtx_tpu_torch.utils import profiling

DT0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
G, B = blocked.GROUP, blocked.BLOCK


@pytest.fixture(scope="module")
def burst_args():
    """_burst_core's arguments for a 128x96 frame of a march-path scene
    (shadows, bounce light, eclipse shading and earthshine on)."""
    elev, albedo = synthesize_moon(180, 360, seed=5, n_craters=60)
    rs = float(elev.max())
    cfg = RenderConfig(observer=Observer(50.06, 19.94, 219), dt_local=DT0,
                       width=128, height=96, backend="pallas",
                       shadow_accuracy=4).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                  device="cpu")
    s.update_view()
    s.render(1)
    level = s.mip_level()
    h, w = s.mip_shapes[level]
    ah, aw = s.mip_shapes[s.albedo_level(level)]
    s._rng = np.random.default_rng(7)
    return dict(packed=s._packed, smap_params=s.shadow_args()[1],
                background=s.background(), maxmap=s.maxmap,
                basis=s.render_basis(), fp=s._fp,
                jitters=s._padded_jitters(8), height=s.height,
                width=s.width, h=h, w=w, h_min=s.h_min, ah=ah, aw=aw,
                n_coarse=12, use_shadow=True, hbound=s._hbound)


def loop_burst(packed, smap_params, background, maxmap, basis, fp, jitters,
               height, width, h, w, h_min, ah, aw, n_samples, n_coarse,
               use_shadow, hbound=None):
    """_burst_core before the burst kernel: per sample block_rays, one
    march_shade, and the running mean in torch."""
    ob = mat3t_apply(fp.rotation, basis.eye)
    params = blocked._kernel_params(ob, fp, smap_params, use_shadow,
                                    2.0 * basis.tan_half_fov / height, ah,
                                    aw)
    geom0 = blocked.block_rays(basis, fp.rotation, jitters[0], height,
                               width, h_min, maxmap=maxmap, h_bound=hbound)
    ns = geom0.db.shape[0] // G
    h_bound = geom0.h_bound

    def run_kernel(geom, t_prev=None, f_prev=None):
        dbx, dby, dbz = (geom.db[..., i].reshape(ns, G, B)
                         for i in range(3))
        t0 = geom.t_enter.reshape(ns, G, B)
        t1 = geom.t_end.reshape(ns, G, B)
        act = geom.hit_outer.to(torch.float32).reshape(ns, G, B)
        return mk.march_shade(
            params, dbx, dby, dbz, t0, t1, act, packed.scal, packed.hwin,
            packed.awin, packed.swin, h=h, w=w, n_coarse=n_coarse,
            use_shadow=use_shadow, use_earth=fp.earth is not None,
            t_prev=t_prev, f_prev=f_prev)

    r0, g0, b0, hit0, t0_, px0, py0, pz0 = run_kernel(geom0)
    ar, ag, ab, tp, fpv = r0, g0, b0, t0_, hit0
    for i in range(1, n_samples):
        geom = blocked.block_rays(basis, fp.rotation, jitters[i], height,
                                  width, h_min, h_bound=h_bound,
                                  image_dirs=False)
        r, g, b, hitf, t_hit, *_ = run_kernel(geom, t_prev=tp, f_prev=fpv)
        k = i + 1.0
        ar, ag, ab = ar + (r - ar) / k, ag + (g - ag) / k, ab + (b - ab) / k
        tp, fpv = t_hit, hitf
    return blocked.composite_kernel_outputs(
        ar, ag, ab, hit0, t0_, px0, py0, pz0, height, width,
        geom0.dirs_scene, basis.eye, fp, background=background)


@pytest.mark.parametrize("n_samples", [1, 2, 5])
def test_burst_frame_equals_the_sample_loop(burst_args, n_samples,
                                            monkeypatch):
    plain_calls = []
    real = mk.march_burst_plain

    def spy(*a, **k):
        plain_calls.append(a[19])                     # n_samples
        return real(*a, **k)

    monkeypatch.setattr(mk, "march_burst_plain", spy)
    rgb, hitbuf = blocked._burst_core(n_samples=n_samples, **burst_args)
    rgb_l, hitbuf_l = loop_burst(n_samples=n_samples, **burst_args)
    assert torch.equal(rgb, rgb_l) and torch.equal(hitbuf, hitbuf_l)
    assert plain_calls == ([n_samples] if n_samples > 1 else [])
    assert float(hitbuf[..., 3].gt(0).float().mean()) > 0.2


def test_burst_counts_its_fused_samples(burst_args, monkeypatch):
    bursts = []
    real = mk.march_burst_plain

    def spy(*a, **k):
        bursts.append(a[19])                          # n_samples
        return real(*a, **k)

    monkeypatch.setattr(mk, "march_burst_plain", spy)
    launches = kernels.launch_counts()["march_burst"]
    for n, fused in ((4, 3), (1, 0), (2, 1)):
        before = profiling.counters().get("burst.fused_samples", 0)
        blocked._burst_core(n_samples=n, **burst_args)
        after = profiling.counters().get("burst.fused_samples", 0)
        assert after - before == fused
    assert bursts == [4, 2]
    # no kernel off the card
    assert kernels.launch_counts()["march_burst"] == launches


def test_burst_takes_more_samples_than_sample_zero(burst_args):
    """A longer burst moves the mean: the samples are all computed."""
    r2, _ = blocked._burst_core(n_samples=2, **burst_args)
    r5, _ = blocked._burst_core(n_samples=5, **burst_args)
    assert float((r5 - r2).abs().max()) > 1e-3


def test_march_burst_refuses_what_it_cannot_run(burst_args):
    a = burst_args
    ns = a["packed"].hwin.shape[0]
    plane = torch.zeros((ns, G, B))
    params = torch.zeros((mk.N_PARAMS, G, B))
    p = a["packed"]
    common = dict(params=params, basis=a["basis"], rotation=a["fp"].rotation,
                  h_bound=a["hbound"], r=plane, g=plane, b=plane,
                  t_prev=plane, f_prev=plane, scal=p.scal, hwin=p.hwin,
                  awin=p.awin, swin=p.swin, h=a["h"], w=a["w"],
                  height=a["height"], width=a["width"], h_min=a["h_min"])
    with pytest.raises(ValueError, match="jitter rows"):
        mk.march_burst(jitters=torch.zeros((4, 2)), n_samples=5, **common)
    with pytest.raises(ValueError, match="jitter rows"):
        mk.march_burst(jitters=torch.zeros((4, 2)), n_samples=1, **common)
    with pytest.raises(ValueError, match="expected"):
        mk.march_burst(jitters=torch.zeros((4, 2), dtype=torch.float64),
                       n_samples=3, **common)
    with pytest.raises(ValueError, match="strips"):
        mk.march_burst(jitters=torch.zeros((4, 2)), n_samples=3,
                       **dict(common, width=a["width"] // 2))


def test_burst_plain_builds_its_rays_without_the_wrapper(burst_args,
                                                         monkeypatch):
    """Off the card the burst's plain version runs, and it builds every
    warm sample's rays with block_rays_plain, never through the kernel's
    wrapper: the wrapper runs once, for sample 0, in _burst_core."""
    from moonrtx_tpu_torch.ops import ray_setup

    wrapped, plain = [], []
    real_wrapper, real_plain = ray_setup.block_rays, ray_setup.block_rays_plain

    def spy_wrapper(*a, **k):
        wrapped.append(1)
        return real_wrapper(*a, **k)

    def spy_plain(*a, **k):
        plain.append(k.get("image_dirs", True))
        return real_plain(*a, **k)

    monkeypatch.setattr(ray_setup, "block_rays", spy_wrapper)
    monkeypatch.setattr(ray_setup, "block_rays_plain", spy_plain)
    monkeypatch.setattr(mk, "block_rays_plain", spy_plain)
    rgb, _ = blocked._burst_core(n_samples=5, **burst_args)
    assert wrapped == [1]
    assert plain == [True] + [False] * 4
    rgb_l, _ = loop_burst(n_samples=5, **burst_args)
    assert torch.equal(rgb, rgb_l)
