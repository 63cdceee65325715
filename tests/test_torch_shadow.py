"""The port's shadow scan against the reference: the prefix-max kernel
(K3) against its Pallas kernel in interpret mode on rounding-free inputs
(tests/test_shadow_prefix.py's), and the whole scan + bounce pyramid
against the reference's kernel path on a small synthetic map.

Tolerances: K3 within 1e-4 on rounding-free inputs (the atan2 polynomial
over a penumbra ramp). The bounce map within 2e-3. The shadow map within
5e-3 except on at most the share of texels that 1-ulp noise on every
input of the reference's own prefix scan moves the reference by more than
5e-3 (torch_parity.scan_self_noise; the test asserts that share is
nonzero): right behind a blocker the factor atan2(m_max - m, z_at - z) /
(2 sar) divides by a tiny z_at - z, and the two frameworks' sin/asin/atan2
differ by ulps (the reference's XLA also fuses m_max - r*sin into one
rounding).

The scan's other branches: the ungrouped resample (windows cut by K5,
blended by level, bf16 row mix) against the reference's, within 4e-3 of
the heights' spread (the bf16 residual budget), once through the
reference's plain slices and once through its K5 kernel in interpret
mode; the running max in plain torch ops against the reference's
associative scan on rounding-free inputs within 1e-5, ties included; the
gather scan (blocked_resample=False) with heights within 1e-6 and the
factor within 5e-3 on all but the share of texels that 1-ulp noise on the
reference's own heights moves; shadow_lookup within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonrtx_tpu import constants as C
from moonrtx_tpu.ops import shadow_prefix as jprefix
from moonrtx_tpu.ops import shadow_scan as jscan
from moonrtx_tpu_torch.ops import shadow_prefix as tprefix
from moonrtx_tpu_torch.ops import shadow_scan as tscan
from torch_parity import (SHADOW_FAMILIES, SHADOW_SAR, jax_kernel_path,
                          scan_self_noise, shadow_hard_case, ulp_noise)


def _exact_inputs(n_theta, n_phi, seed=7):
    rng = np.random.default_rng(seed)
    q = 2.0 ** -8
    hs = np.round((1.0 + 0.004 * rng.standard_normal((n_theta, n_phi))
                   + 0.01 * (rng.random((n_theta, n_phi)) < 0.002)) / q) * q
    tgrid = np.linspace(0.05, 0.95, n_theta)
    st = np.round(np.sin(np.pi * tgrid)[:, None] / q) * q
    ct = np.round(np.cos(np.pi * tgrid)[:, None] / q) * q
    return [a.astype(np.float32) for a in (hs, st, ct)]


def _both(hs, st, ct, sar):
    ref = np.asarray(jprefix.shadow_factor_tpu(
        *(jnp.asarray(a) for a in (hs, st, ct)), jnp.float32(sar),
        C.MOON_RADIUS, interpret=True))
    got = tprefix.shadow_factor(*(torch.from_numpy(a) for a in (hs, st, ct)),
                                sar, C.MOON_RADIUS).numpy()
    return got, ref


@pytest.mark.parametrize("n_theta,n_phi", [(256, 128), (512, 256)])
def test_shadow_factor_matches_kernel(n_theta, n_phi):
    got, ref = _both(*_exact_inputs(n_theta, n_phi), 0.0046)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_shadow_factor_tie_breaking():
    """Equal keys along a meridian keep the EARLIEST blocker's z."""
    n_theta, n_phi = 256, 128
    st = np.repeat([0.5, 0.25, 0.125, 0.0625], 64)[:, None]
    hs = np.broadcast_to(np.repeat([0.5, 1.0, 2.0, 4.0], 64)[:, None],
                         (n_theta, n_phi)).copy()
    hs[5, :] *= 1.0 + 2.0 ** -6
    hs[100, :] *= 1.0 + 2.0 ** -6
    ct = np.repeat([0.5, 0.5, -0.25, -0.5], 64)[:, None]
    got, ref = _both(*(a.astype(np.float32) for a in (hs, st, ct)), 0.01)
    assert (0.05 < ref[128:, 0]).all() and (ref[128:, 0] < 0.45).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("n_theta", [256, 384])
@pytest.mark.parametrize("family", SHADOW_FAMILIES)
def test_shadow_factor_hard_cases(family, n_theta):
    """The inputs a split of theta across thread blocks gets wrong (tied
    keys over every multiple of 16 rows, the maximum in row 0, rising and
    falling columns): the plain version gives what the reference kernel
    gives, within the atan2 polynomial's 1e-4, on factors that lie
    strictly inside (0, 1) and so move with the carried (m_max, z_at)."""
    hs, st, ct = shadow_hard_case(family, n_theta, 128, seed=3)
    ref = np.asarray(jprefix.shadow_factor_tpu(
        *(jnp.asarray(a) for a in (hs, st, ct)), jnp.float32(SHADOW_SAR),
        C.MOON_RADIUS, interpret=True))
    got = tprefix.shadow_factor_plain(
        *(torch.from_numpy(a) for a in (hs, st, ct)), SHADOW_SAR,
        C.MOON_RADIUS).numpy()
    assert ((ref > 0.0) & (ref < 1.0)).mean() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_prefix_ok_shapes():
    for shape in ((1536, 4096), (2304, 2048), (512, 512), (100, 4096),
                  (1536, 100)):
        assert tprefix.prefix_ok(*shape) == jprefix.prefix_ok(*shape)


def test_scan_grid_helpers():
    for acc in (1, 4, 10, 20):
        assert tscan._resolution(acc) == jscan._resolution(acc)
    nc, nf, _ = tscan._resolution(10)
    np.testing.assert_array_equal(tscan._theta_grid(nc, nf),
                                  jscan._theta_grid(nc, nf))
    theta = np.linspace(0.0, 105.0, 97).astype(np.float32)
    ref = np.asarray(jscan._theta_to_row(jnp.asarray(theta), nc, nf))
    got = tscan._theta_to_row(torch.from_numpy(theta), nc, nf).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    rng = np.random.default_rng(1)
    # quantized levels decimate exactly; f32 means sum in another order
    for a, tol in ((rng.integers(-3000, 3000, (66, 90)).astype(np.int16), 0),
                   (rng.random((66, 90)).astype(np.float32), 1e-6)):
        np.testing.assert_allclose(
            tscan._decimate_tex(torch.from_numpy(a)).numpy(),
            np.asarray(jscan._decimate_tex(jnp.asarray(a))), rtol=tol,
            atol=0)


@pytest.fixture(scope="module")
def scan_inputs():
    from moonrtx_tpu.data.pyramids import load_or_build
    from moonrtx_tpu.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    ps = load_or_build((elev / elev.max()).astype(np.float32), albedo,
                       False, use_cache=False)
    tex = ps.mips[0]
    alb_lum = ps.albedo_kept[0].mean(axis=2).astype(np.float32)
    sun = np.array([0.6, -0.7, 0.3])
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    return tex, alb_lum, sun


def test_shadow_and_bounce_match_reference(scan_inputs):
    tex, alb_lum, sun = scan_inputs
    h, w = tex.shape[0], tex.shape[1] - 192
    ang = 0.0046
    with jax_kernel_path():
        smap_j, params_j, bmap_j = jscan.build_shadow_and_bounce(
            jnp.asarray(tex), jnp.asarray(alb_lum), h, w, jnp.asarray(sun),
            ang, accuracy=4)
        smap_j, bmap_j = np.asarray(smap_j), np.asarray(bmap_j)
        smap_r, noisy = scan_self_noise(tex, alb_lum, sun, ang, h, w, 4)
    np.testing.assert_array_equal(smap_r, smap_j)
    noise_share = (np.abs(noisy - smap_j) > 5e-3).mean()
    assert 0 < noise_share < 0.01
    smap_t, params_t, bmap_t = tscan.build_shadow_and_bounce(
        torch.from_numpy(tex), torch.from_numpy(alb_lum),
        h, w, torch.from_numpy(sun), ang, accuracy=4)
    for a, b in ((params_t.axis_x, params_j.axis_x),
                 (params_t.axis_z, params_j.axis_z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert smap_t.shape == smap_j.shape and bmap_t.shape == bmap_j.shape
    # the map must have both lit and shadowed texels for this to bite
    assert (smap_j > 0.99).mean() > 0.2 and (smap_j < 0.01).mean() > 0.05
    d = np.abs(smap_t.numpy() - smap_j)
    assert (d > 5e-3).mean() <= noise_share and d.mean() < 2e-3
    assert np.abs(bmap_t.numpy() - bmap_j).max() <= 2e-3


def test_bounce_from_parts_matches_reference():
    rng = np.random.default_rng(3)
    nc, nf, nphi = 256, 256, 1024
    hs = (1.0 + 0.002 * rng.standard_normal((nc + nf, nphi))).astype(
        np.float32)
    factor = (rng.random((nc + nf, nphi)) > 0.3).astype(np.float32)
    alb = (0.1 + 0.1 * rng.random((nc + nf, nphi))).astype(np.float32)
    ref = np.asarray(jscan.bounce_from_parts(
        jnp.asarray(hs), jnp.asarray(factor), jnp.asarray(alb), nc, nf,
        nphi))
    got = tscan.bounce_from_parts(torch.from_numpy(hs),
                                  torch.from_numpy(factor),
                                  torch.from_numpy(alb), nc, nf, nphi)
    assert np.abs(got.numpy() - ref).max() <= 2e-3


def test_bounce_wrapper_takes_the_plain_path_on_the_cpu():
    """A CPU tensor takes the plain version (no launch); any other device
    takes the kernels, which refuse a grid they do not tile before they
    touch the device."""
    rng = np.random.default_rng(4)
    nc, nf, nphi = 64, 64, 256
    shape = (nc + nf, nphi)
    hs = torch.from_numpy((1.0 + 0.002 * rng.standard_normal(shape))
                          .astype(np.float32))
    factor = torch.from_numpy((rng.random(shape) > 0.3).astype(np.float32))
    alb = torch.from_numpy((0.1 + 0.1 * rng.random(shape)).astype(np.float32))
    n0 = tscan.bounce_from_parts.launches
    for n_bounces in (1, 2):
        got = tscan.bounce_from_parts(hs, factor, alb, nc, nf, nphi,
                                      n_bounces=n_bounces)
        assert torch.equal(got, tscan.bounce_from_parts_plain(
            hs, factor, alb, nc, nf, nphi, n_bounces=n_bounces))
    assert tscan.bounce_from_parts.launches == n0
    assert tscan.bounce_ok(nc + nf, nphi) and not tscan.bounce_ok(96, 512)
    meta = torch.empty((96, 512), device="meta")
    with pytest.raises(ValueError, match="unsupported bounce grid"):
        tscan.bounce_from_parts(meta, meta, meta, 32, 64, 512)
    assert tscan.bounce_from_parts.launches == n0


@pytest.mark.parametrize("grid", [(256, 1280, 4096), (256, 256, 2048),
                                  (32, 32, 128)])
def test_bounce_rows_match_the_plain_version(grid):
    """The kernels' per-row table holds, bit for bit, the row arrays the
    plain version forms on the card (bounce_from_parts_plain,
    _sector_collapse): torch's float32 products, sums, minima and maxima,
    and a correctly rounded square root, as the card's sqrtf gives it
    (torch's vectorised sqrt on the CPU can be 1 ulp off)."""
    nc, nf, nphi = grid
    rows = tscan.bounce_rows(nc, nf, nphi)
    theta0 = np.deg2rad(tscan._theta_grid(nc, nf)).astype(np.float32)
    dphi = 2.0 * np.pi / nphi
    st0 = np.sin(theta0).astype(np.float32)
    want = [np.gradient(theta0).astype(np.float32), st0,
            (dphi * torch.as_tensor(np.maximum(st0, 0.05))).numpy(),
            np.cos(theta0)]
    theta_k = theta0
    n_levels = tscan.bounce_levels(nc + nf, nphi)
    for k in range(n_levels):
        dth_k = torch.as_tensor(np.maximum(np.gradient(theta_k), 1e-6)
                                .astype(np.float32))
        st_k = torch.as_tensor(np.sin(theta_k).astype(np.float32))
        dl_phi = torch.minimum(torch.maximum(dphi * (2 ** k) * st_k,
                                             dth_k * 0.25), dth_k * 4.0)
        diag = np.sqrt((dth_k * dth_k + dl_phi * dl_phi).numpy()
                       .astype(np.float64)).astype(np.float32)
        want += [dth_k.numpy(), dl_phi.numpy(), diag]
        theta_k = 0.5 * (theta_k[::2] + theta_k[1::2])
    want = np.concatenate(want)
    assert rows.dtype == np.float32 and rows.shape == want.shape
    np.testing.assert_array_equal(rows.view(np.int32), want.view(np.int32))
    assert n_levels == (7 if grid[2] == 4096 else
                        6 if grid[2] == 2048 else 3)


def _scan_args(tex, sun, n_phi):
    basis_j = jnp.stack(jscan.sun_frame_basis(jnp.asarray(sun)))
    basis_t = torch.stack(tscan.sun_frame_basis(torch.from_numpy(sun)))
    h, w = tex.shape[0], tex.shape[1] - 192
    return basis_j, basis_t, (h, w, 64, 64, n_phi, 0, n_phi)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_ungrouped_resample_matches_reference(scan_inputs, kernel_path):
    """A resample group that does not divide the block count takes the
    ungrouped branch: K5 windows per level, blend, bf16 row mix."""
    tex, _, sun = scan_inputs
    basis_j, basis_t, grid = _scan_args(tex, sun, 512)
    ang = 0.0046
    nb = (128 // 8) * (512 // 64)
    assert nb % 7 != 0

    def ref():
        return jscan.scan_wedge(
            jnp.asarray(tex), basis_j, jnp.float32(ang), *grid,
            blocked_resample=True, return_heights=True, resample_group=7)

    if kernel_path:
        with jax_kernel_path():
            _, hs_j = ref()
    else:
        _, hs_j = ref()
    from moonrtx_tpu_torch.ops import extract as tx
    n5, n4 = tx.extract_level_windows.launches, tx.resample_group_windows.launches
    factor_t, hs_t = tscan.scan_wedge(
        torch.from_numpy(tex), basis_t, ang, *grid, blocked_resample=True,
        return_heights=True, resample_group=7)
    assert tx.extract_level_windows.launches == n5      # CPU: plain versions
    assert tx.resample_group_windows.launches == n4
    hs_j = np.asarray(hs_j)
    assert hs_t.shape == hs_j.shape == (128, 512)
    spread = float(hs_j.max() - hs_j.min())
    assert spread > 1e-3
    assert np.abs(hs_t.numpy() - hs_j).max() <= 4e-3 * spread
    assert np.abs(hs_t.numpy() - hs_j).mean() <= 1e-4 * spread
    # the grouped branch (K4) samples the same heights within the budget
    _, hs_g = tscan.scan_wedge(
        torch.from_numpy(tex), basis_t, ang, *grid, blocked_resample=True,
        return_heights=True, resample_group=8)
    assert np.abs(hs_g.numpy() - hs_t.numpy()).max() <= 4e-3 * spread
    assert factor_t.shape == (128, 512)
    assert 0.0 <= float(factor_t.min()) and float(factor_t.max()) <= 1.0


def _xla_running_max(hs, st, ct, sar):
    """The lines the reference's scan_wedge lowers without its kernel."""
    import jax

    n_phi = hs.shape[1]
    r = C.MOON_RADIUS * hs
    m = r * st
    z = r * ct
    neg = jnp.full((1, n_phi), -1.0, m.dtype)
    m_pad = jnp.concatenate([neg, m[:-1]], axis=0)
    z_pad = jnp.concatenate([jnp.zeros((1, n_phi), z.dtype), z[:-1]], axis=0)
    m_max, z_at = jax.lax.associative_scan(
        jscan._argmax_combine, (m_pad, z_pad), axis=0)
    dz = jnp.maximum(z_at - z, 1e-6)
    alpha = jnp.arctan2(m_max - m, dz)
    factor = jnp.clip(0.5 - alpha / (2.0 * sar), 0.0, 1.0)
    return jnp.where(m_max < 0.0, 1.0, factor)


def test_running_max_factor_matches_associative_scan():
    hs, st, ct = _exact_inputs(256, 128)
    # plateaus of equal keys: the earliest blocker's z must win
    hs[40:48, :] = hs[40, :]
    st[40:48] = st[40]
    ref = np.asarray(_xla_running_max(*(jnp.asarray(a) for a in (hs, st, ct)),
                                      jnp.float32(0.0046)))
    got = tscan._running_max_factor(*(torch.from_numpy(a) for a in
                                      (hs, st, ct)), 0.0046).numpy()
    assert 0.05 < (ref < 0.5).mean() < 0.95
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and the tie case of test_shadow_factor_tie_breaking
    st = np.repeat([0.5, 0.25, 0.125, 0.0625], 64)[:, None]
    hs = np.broadcast_to(np.repeat([0.5, 1.0, 2.0, 4.0], 64)[:, None],
                         (256, 128)).copy()
    hs[5, :] *= 1.0 + 2.0 ** -6
    hs[100, :] *= 1.0 + 2.0 ** -6
    ct = np.repeat([0.5, 0.5, -0.25, -0.5], 64)[:, None]
    a = [x.astype(np.float32) for x in (hs, st, ct)]
    ref = np.asarray(_xla_running_max(*(jnp.asarray(x) for x in a),
                                      jnp.float32(0.01)))
    got = tscan._running_max_factor(*(torch.from_numpy(x) for x in a),
                                    0.01).numpy()
    assert (0.05 < ref[128:, 0]).all() and (ref[128:, 0] < 0.45).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_gather_scan_matches_reference(scan_inputs):
    """blocked_resample=False: gather resample + running max, with the
    albedo resample; no kernel on either side."""
    tex, alb_lum, sun = scan_inputs
    basis_j, basis_t, grid = _scan_args(tex, sun, 500)   # not prefix_ok
    ang = 0.0046
    f_j, hs_j, alb_j = (np.asarray(a) for a in jscan.scan_wedge(
        jnp.asarray(tex), basis_j, jnp.float32(ang), *grid,
        blocked_resample=False, alb_lum=jnp.asarray(alb_lum)))
    f_t, hs_t, alb_t = (a.numpy() for a in tscan.scan_wedge(
        torch.from_numpy(tex), basis_t, ang, *grid, blocked_resample=False,
        alb_lum=torch.from_numpy(alb_lum)))
    np.testing.assert_allclose(hs_t, hs_j, atol=1e-6)
    np.testing.assert_allclose(alb_t, alb_j, atol=1e-5)
    # the factor is chaotic behind a blocker: hold it to what 1-ulp noise
    # on the reference's own heights does to the reference
    st = jnp.sin(jnp.asarray(np.deg2rad(jscan._theta_grid(64, 64))))[:, None]
    ct = jnp.cos(jnp.asarray(np.deg2rad(jscan._theta_grid(64, 64))))[:, None]
    clean = np.asarray(_xla_running_max(jnp.asarray(hs_j), st, ct,
                                        jnp.float32(ang)))
    noisy = np.asarray(_xla_running_max(jnp.asarray(ulp_noise(hs_j, 3)), st,
                                        ct, jnp.float32(ang)))
    np.testing.assert_allclose(clean, f_j, atol=1e-6)
    noise_share = (np.abs(noisy - clean) > 5e-3).mean()
    d = np.abs(f_t - f_j)
    assert (d > 5e-3).mean() <= max(noise_share, 1e-3) and d.mean() < 2e-3
    assert (f_j > 0.99).mean() > 0.2 and (f_j < 0.01).mean() > 0.05
    # return_heights without the albedo map
    f2, hs2 = tscan.scan_wedge(torch.from_numpy(tex), basis_t, ang, *grid,
                               blocked_resample=False, return_heights=True)
    assert np.array_equal(f2.numpy(), f_t) and np.array_equal(hs2.numpy(),
                                                              hs_t)


def test_shadow_lookup_matches_reference():
    rng = np.random.default_rng(9)
    nc, nf, nphi = 64, 64, 256
    smap = rng.random((nc + nf, nphi + 2)).astype(np.float32)
    sun = np.array([0.6, -0.7, 0.3], np.float32)
    sun /= np.linalg.norm(sun)
    x_j, y_j, z_j = jscan.sun_frame_basis(jnp.asarray(sun))
    pj = jscan.ShadowMapParams(
        axis_x=x_j, axis_y=y_j, axis_z=z_j, n_coarse=jnp.float32(nc),
        n_fine=jnp.float32(nf), n_phi=jnp.float32(nphi),
        sun_ang_radius=jnp.float32(0.0046))
    pt = tscan._params(torch.stack([torch.from_numpy(np.array(a))
                                    for a in (x_j, y_j, z_j)]),
                       nc, nf, nphi, 0.0046)
    p = rng.standard_normal((40, 128, 3)).astype(np.float32)
    p *= 10.0 / np.linalg.norm(p, axis=-1, keepdims=True)
    ref = np.asarray(jscan.shadow_lookup(jnp.asarray(smap), pj,
                                         jnp.asarray(p)))
    got = tscan.shadow_lookup(torch.from_numpy(smap), pt,
                              torch.from_numpy(p)).numpy()
    assert (ref == 0).mean() > 0.2 and (ref > 0).mean() > 0.3
    # a point within an ulp of the scanned band's edge may fall either side
    edge = (ref == 0) != (got == 0)
    assert edge.mean() < 1e-3
    np.testing.assert_allclose(got[~edge], ref[~edge], atol=2e-4)
