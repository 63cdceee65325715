"""Helpers for the tests that hold moonrtx_tpu_torch against moonrtx_tpu.

``jax_kernel_path`` makes the reference take its TPU kernel path on the
CPU, as tests/test_pallas_kernel.py does: ``_fast_ok`` forced true and the
Pallas kernels wrapped with ``interpret=True``. The jitted programs that
baked in the other path are cleared on entry and again on exit, so the
reference package is left as it was found.

Importing this module also pins PyTorch to one CPU thread and starts
its thread pool (see ``_start_torch_threads``), so every test file that
compares frames imports it.

``blocked_sample_variant`` turns a recorded call of the blocked
backend's sample into each input it takes besides a scene's own.

``shadow_hard_case``, ``resample_hard_case`` and ``extract_hard_case``
are the one numpy generator of the inputs a wrong split of a kernel's
work gets wrong (moonrtx_tpu_torch/hard_cases.py, which the card's smoke
run replays too); ``resample_case_with`` and ``extract_case_calls`` hand
one case to either framework.
"""

import contextlib

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch.hard_cases import (  # noqa: F401  (for the tests)
    EXTRACT_DTYPES, EXTRACT_FAMILIES, EXTRACT_GUARD_FAMILIES,
    RESAMPLE_DTYPES, RESAMPLE_FAMILIES, RESAMPLE_GUARD_FAMILIES,
    SHADOW_FAMILIES, SHADOW_SAR, extract_case_calls, extract_hard_case,
    resample_case_with, resample_hard_case, shadow_hard_case)


def _start_torch_threads():
    """Pin PyTorch to one CPU thread, then run one reduction before any
    test computes with torch.

    The suite runs in several worker processes on one host. Each
    process's own pool of one thread per core then oversubscribes the
    cores, and the small operations these tests issue by the thousand
    wait on each other's threads: a scene test that takes 7 s alone took
    over 14 minutes with five more processes beside it, and 26 s with one
    thread a process.

    The first parallel region of a process starts PyTorch's CPU thread
    pool. On some hosts the operation that follows that first reduction
    has been seen to read one worker's chunk of the result before its
    final value was stored: the sqrt of a keepdim sum came out 3e-4 off
    in 14 of 112 rows, in about a quarter of fresh processes and never
    on a later call, which bends the ray directions of the first frame a
    process renders by far more than any tolerance here. One throwaway
    reduction absorbs it."""
    torch.set_num_threads(1)
    w = torch.ones(256, 256, 3)
    torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True))


_start_torch_threads()


def _clear_jax_caches():
    from moonrtx_tpu.engine import blocked
    from moonrtx_tpu.ops import shadow_scan

    for fn in (blocked.extract_window_cache, blocked.build_shadow_windows,
               blocked.render_timestep_pallas,
               blocked.render_timestep_scan_pallas,
               blocked.render_pose_pallas, blocked.render_accumulate_pallas,
               blocked.build_shadow_state_from_maps, shadow_scan._build,
               shadow_scan._build_aux):
        fn.clear_cache()


@contextlib.contextmanager
def jax_kernel_path():
    from moonrtx_tpu.ops import extract, shadow_prefix

    def interpreted(fn):
        return lambda *a, **k: fn(*a, **{**k, "interpret": True})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(extract, "_fast_ok", lambda: True)
        mp.setattr(extract, "extract_group_windows_tpu",
                   interpreted(extract.extract_group_windows_tpu))
        mp.setattr(extract, "extract_level_windows_tpu",
                   interpreted(extract.extract_level_windows_tpu))
        mp.setattr(extract, "extract_windows_tpu",
                   interpreted(extract.extract_windows_tpu))
        mp.setattr(extract, "resample_group_windows_tpu",
                   interpreted(extract.resample_group_windows_tpu))
        mp.setattr(shadow_prefix, "shadow_factor_tpu",
                   interpreted(shadow_prefix.shadow_factor_tpu))
        _clear_jax_caches()
        try:
            yield
        finally:
            _clear_jax_caches()
    _clear_jax_caches()


def ulp_noise(a, seed: int):
    """float32 ``a`` with every element moved one ulp up or down, the
    direction drawn per element from ``seed``."""
    a = np.asarray(a, np.float32)
    up = np.random.default_rng(seed).random(a.shape) < 0.5
    return np.nextafter(a, np.where(up, np.inf, -np.inf).astype(np.float32))


def scan_self_noise(tex, alb_lum, sun, ang: float, h: int, w: int,
                    accuracy: int, h_scale: float = 1.0,
                    h_offset: float = 0.0, seed: int = 0):
    """The reference's shadow map, and the same map rescanned after 1-ulp
    noise (``ulp_noise``) on every input of its prefix scan: the heights
    resampled onto the scan grid and the rows' sin/cos. Call inside
    ``jax_kernel_path``. Returns (smap, noisy_smap), numpy, same layout."""
    import jax.numpy as jnp

    from moonrtx_tpu import constants as C
    from moonrtx_tpu.ops import shadow_prefix, shadow_scan

    nc, nf, nphi = shadow_scan._resolution(accuracy)
    basis = jnp.stack(shadow_scan.sun_frame_basis(
        jnp.asarray(sun, jnp.float32)))
    smap, hs, _ = shadow_scan._build_aux(
        jnp.asarray(tex), jnp.asarray(alb_lum), basis, jnp.float32(ang),
        h, w, nc, nf, nphi, h_scale=h_scale, h_offset=h_offset)
    theta = jnp.asarray(np.deg2rad(shadow_scan._theta_grid(nc, nf)))[:, None]
    inputs = (hs, jnp.sin(theta), jnp.cos(theta))
    noisy = np.asarray(shadow_prefix.shadow_factor_tpu(
        *(jnp.asarray(ulp_noise(a, seed + k)) for k, a in enumerate(inputs)),
        jnp.float32(ang), C.MOON_RADIUS, interpret=True))
    noisy = np.concatenate([noisy, noisy[:, :shadow_scan.PHI_PAD]], axis=1)
    return np.asarray(smap), noisy


def _packed_awin(cache):
    """The same albedo windows in K1's packed channel-major layout."""
    from moonrtx_tpu_torch.engine import blocked

    nblk = cache.awin.shape[0]
    awin = torch.movedim(cache.awin, 3, 2).reshape(
        nblk // blocked.GROUP, blocked.GROUP * blocked.AWIN_H,
        3 * blocked.AWIN_W)
    return cache._replace(awin=awin.contiguous())


def blocked_sample_variant(call, name: str) -> dict:
    """A recorded call of ops.blocked_sample changed into one of
    BLOCKED_SAMPLE_VARIANTS: the inputs the blocked backend's sample takes
    besides those a scene renders with (its own call is "as_rendered").
    The call has shadow windows with the bounce half, lunar-Lambert
    shading and the Earth terms."""
    from moonrtx_tpu_torch.engine import blocked

    sw = call["shadow_windows"]
    if name == "no_shadows":
        return dict(call, shadow_windows=None)
    if name == "no_bounce":
        return dict(call, shadow_windows=sw._replace(
            swin=sw.swin[..., :blocked.SWIN_W].contiguous()))
    if name == "packed_albedo":
        return dict(call, cache=_packed_awin(call["cache"]))
    if name == "star_background":
        g = torch.Generator().manual_seed(3)
        bg = 0.05 * torch.rand((call["height"], call["width"], 3),
                               generator=g)
        return dict(call, background=bg.to(call["geom"].db.device))
    if name == "lambert_no_earth":
        return dict(call, fp=call["fp"]._replace(lunar_blend=None,
                                                 earth=None))
    if name == "no_eclipse":
        earth = call["fp"].earth.clone()
        earth[4] = 0.0              # the Earth's angular radius
        return dict(call, fp=call["fp"]._replace(earth=earth))
    if name == "bf16_shadow_windows":
        return dict(call, shadow_windows=sw._replace(
            swin=sw.swin.to(torch.bfloat16)))
    assert name == "as_rendered", name
    return call


BLOCKED_SAMPLE_VARIANTS = ["as_rendered", "no_shadows", "no_bounce",
                           "packed_albedo", "star_background",
                           "lambert_no_earth", "no_eclipse",
                           "bf16_shadow_windows"]
