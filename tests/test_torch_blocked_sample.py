"""The blocked backend's one-launch sample (ops/blocked_sample.py) on the
CPU: the wrapper takes the plain version there, which is the composition
of march_blocks, lookup_shadow_windows, shade_blocks and composite_blocks
that render_frame_blocked made before the kernel; it checks its inputs,
and it is a kernel wrapper the counters report. The kernel itself is held
to the plain version on the card (tests/test_torch_gpu.py)."""

import inspect
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from torch_parity import BLOCKED_SAMPLE_VARIANTS, blocked_sample_variant
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.ops import blocked_sample as bs
from moonrtx_tpu_torch.utils import profiling


def _scene(backend="blocked", **kw):
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.types import Observer

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=128, height=96, shadow_accuracy=4, backend=backend,
        **kw).validate()
    return MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                     device="cpu")


@pytest.fixture(scope="module")
def sample_calls():
    """The arguments of the two samples render_frame_blocked got from a
    scene's render(2) (sample 0 at the march phase 0.5, sample 1 at a
    drawn one), with lunar-Lambert shading, shadows and bounce light."""
    s = _scene(photometric="lunar")
    s.shadows_on = True
    s.update_view()
    calls = []
    real = bs.blocked_sample
    sig = inspect.signature(real)

    def spy(*args, **kw):
        calls.append(dict(sig.bind(*args, **kw).arguments))
        return real(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(bs, "blocked_sample", spy)
    try:
        s.render(2)
    finally:
        mp.undo()
    assert len(calls) == 2
    return calls


def _four_functions(cache, org, geom, shadow_windows, smap_params,
                    background, basis, fp, jitter_t, height, width, h, w,
                    ah, aw, n_phi=0, n_coarse=24):
    """render_frame_blocked's body before the kernel."""
    hit, t_hit, lat, lon, p = blocked.march_blocks(
        cache, org, geom, h, w, jitter_t, n_coarse=n_coarse)
    if shadow_windows is not None:
        shadow, bounce = blocked.lookup_shadow_windows(
            shadow_windows, smap_params, n_phi, p)
    else:
        shadow, bounce = torch.ones_like(t_hit), None
    pix_ang = 2.0 * basis.tan_half_fov / height
    rgb_b = blocked.shade_blocks(cache, org, h, w, ah, aw, lat, lon, p, fp,
                                 shadow, geom=geom, t_hit=t_hit,
                                 pix_ang=pix_ang, bounce=bounce)
    return blocked.composite_blocks(rgb_b, hit, t_hit, p, height, width,
                                    geom.dirs_scene, basis.eye, fp,
                                    background=background)


@pytest.mark.parametrize("sample", [0, 1], ids=["jitter_0.5", "drawn"])
@pytest.mark.parametrize("variant", BLOCKED_SAMPLE_VARIANTS)
def test_cpu_call_is_the_four_function_composition(sample_calls, sample,
                                                   variant):
    call = blocked_sample_variant(sample_calls[sample], variant)
    assert call["shadow_windows"] is not None or variant == "no_shadows"
    n0 = kernels.launch_counts()["blocked_sample"]
    got = bs.blocked_sample(**call)
    rgb, hitbuf = _four_functions(**call)
    # no kernel on the CPU
    assert kernels.launch_counts()["blocked_sample"] == n0
    assert torch.equal(got.rgb, rgb) and torch.equal(got.hitbuf, hitbuf)
    hit = hitbuf[..., 3] > 0
    assert 0.2 < float(hit.float().mean()) < 0.9
    assert float(rgb[hit].max()) > 0.0


def test_the_two_samples_differ(sample_calls):
    j0, j1 = (c["jitter_t"] for c in sample_calls)
    assert j0 == 0.5 and j1 != 0.5
    assert not torch.equal(sample_calls[0]["geom"].db,
                           sample_calls[1]["geom"].db)


def _bad(call, what):
    cache, org, geom = call["cache"], call["org"], call["geom"]
    if what == "dtype":
        return dict(call, cache=cache._replace(hwin=cache.hwin.double()))
    if what == "shape":
        return dict(call, org=org._replace(q=org.q[:-1]))
    if what == "device":
        return dict(call, geom=geom._replace(
            t_end=torch.empty_like(geom.t_end, device="meta")))
    if what == "frame":
        return dict(call, height=call["height"] - 4)
    if what == "swin":
        sw = call["shadow_windows"]
        return dict(call, shadow_windows=sw._replace(
            swin=sw.swin[..., :40].contiguous()))
    return dict(call, smap_params=None)


@pytest.mark.parametrize("what", ["dtype", "shape", "device", "frame",
                                  "swin", "no_smap_params"])
def test_wrapper_refuses_what_the_kernel_does_not_take(sample_calls, what):
    with pytest.raises(ValueError, match="blocked_sample"):
        bs.blocked_sample(**_bad(sample_calls[0], what))


def test_wrapper_is_counted():
    assert kernels.wrappers()["blocked_sample"] is bs.blocked_sample
    assert "blocked_sample" in kernels.SOURCES
    assert profiling.counters()["launch.blocked_sample"] == \
        kernels.launch_counts()["blocked_sample"]


@pytest.mark.parametrize("backend", ["auto", "mxu", "blocked"])
def test_default_backend_is_blocked(backend):
    assert _scene(backend=backend).backend == "blocked"
