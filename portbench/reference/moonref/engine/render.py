# Frozen copy of moonrtx_tpu_torch/engine/render.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""The gather render pipeline, shading terms and the display transform
(torch).

Port of moonrtx_tpu/engine/render.py: heightfield intersection and
shading through plain gathers (the scene's "reference" backend; its
render_frame is reference/frame.py::render_view), plus the per-frame
parameters and shading terms every backend shares. The Moon is r(lat, lon) = MOON_RADIUS * h(lat, lon) over an
equirectangular heightfield with peak normalized to 1.0; primary rays
bracket the surface between the bounding and inner spheres with a
fixed-step scan plus bisection refinement.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from reference.moonref import constants as C
from reference.moonref.engine.geometry import (
    latlon_to_unit,
    mat3t_apply,
    normalize,
    ray_sphere,
    unit_to_latlon,
)
from reference.moonref.ops import sampler


class FrameParams(NamedTuple):
    """Per-frame device scalars/small tensors."""

    rotation: torch.Tensor        # (3,3) body->scene
    light_pos: torch.Tensor       # (3,) scene
    sun_disk_center: torch.Tensor # (3,) scene
    sun_disk_radius: torch.Tensor # scalar
    irradiance: torch.Tensor      # scalar linear irradiance factor
    sun_ang_radius: torch.Tensor  # scalar, radians (penumbra width)
    # lunar-Lambert blend L(alpha) for --photometric lunar (None = pure
    # Lambert; engine/light.py lunar_lambert_blend)
    lunar_blend: Optional[torch.Tensor] = None
    # Earth-dependent light terms: (6,) f32 [earth_dir_body xyz, earth
    # distance in scene units, earth angular radius in rad (0 disables
    # eclipse shading), earthshine irradiance relative to direct sunlight
    # (0 disables)]; None = no Earth terms at all.
    earth: Optional[torch.Tensor] = None


def surface_point(tex, lat, lon, h, w):
    """Displaced surface position (body frame) at lat/lon."""
    hs = sampler.sample_latlon(tex, lat, lon, h, w)
    return C.MOON_RADIUS * hs[..., None] * latlon_to_unit(lat, lon), hs


def _field(tex, h, w, ob, db, t):
    """Signed radial distance f(t) = |p| - R*h(latlon(p)); negative inside."""
    p = ob + t[..., None] * db
    lat, lon = unit_to_latlon(p)
    hs = sampler.sample_latlon(tex, lat, lon, h, w)
    return torch.linalg.norm(p, dim=-1) - C.MOON_RADIUS * hs, p, lat, lon


def intersect_heightfield(tex, h: int, w: int, h_min: float, ob, db,
                          n_coarse: int = 48, n_bisect: int = 10):
    """Bracket-and-bisect intersection against the displaced sphere.

    ob: (3,) body-frame ray origin; db: (..., 3) unit directions.
    Returns (hit, t_hit, lat, lon, p_hit). n_coarse samples along each
    ray's in-shell chord find the first sign change; n_bisect bisection
    steps refine it."""
    r_out = C.MOON_RADIUS
    r_in = C.MOON_RADIUS * h_min
    hit_out, t_enter, t_exit_out = ray_sphere(ob, db, r_out)
    hit_in, t_in, _ = ray_sphere(ob, db, r_in * 0.999)
    t_enter = torch.clamp(t_enter, min=0.0)
    t_end = torch.where(hit_in & (t_in > 0), t_in, t_exit_out)

    found = torch.zeros(db.shape[:-1], dtype=torch.bool, device=db.device)
    t_lo, t_hi = t_enter, t_end
    for k in range(n_coarse):
        frac = (k + 1.0) / n_coarse
        t_k = t_enter + (t_end - t_enter) * frac
        f_k = _field(tex, h, w, ob, db, t_k)[0]
        newly = (~found) & (f_k < 0.0) & hit_out
        t_prev = t_enter + (t_end - t_enter) * (k * 1.0 / n_coarse)
        t_lo = torch.where(newly, t_prev, t_lo)
        t_hi = torch.where(newly, t_k, t_hi)
        found = found | newly

    for _ in range(n_bisect):
        t_mid = 0.5 * (t_lo + t_hi)
        outside = _field(tex, h, w, ob, db, t_mid)[0] > 0.0
        t_lo, t_hi = (torch.where(outside, t_mid, t_lo),
                      torch.where(outside, t_hi, t_mid))
    t_hit = 0.5 * (t_lo + t_hi)
    p = ob + t_hit[..., None] * db
    lat, lon = unit_to_latlon(p)
    return found, t_hit, lat, lon, p


def surface_normal(tex, h: int, w: int, lat, lon, hs):
    """Geometric normal from central differences of the displaced surface,
    half-texel spacing, pole-safe."""
    dlat = 0.5 * 180.0 / h
    coslat = torch.clamp(torch.cos(torch.deg2rad(lat)), min=0.05)
    dlon = dlat / coslat
    p_c = C.MOON_RADIUS * hs[..., None] * latlon_to_unit(lat, lon)
    p_n, _ = surface_point(tex, lat + dlat, lon, h, w)
    p_s, _ = surface_point(tex, lat - dlat, lon, h, w)
    p_e, _ = surface_point(tex, lat, lon + dlon, h, w)
    p_w, _ = surface_point(tex, lat, lon - dlon, h, w)
    n = normalize(torch.linalg.cross(p_e - p_w, p_n - p_s))
    # orient outward
    outward = torch.sum(n * p_c, dim=-1, keepdim=True)
    return torch.where(outward < 0.0, -n, n)


def soft_ndotl(mu, sigma):
    """E[max(0, n.l)] under a Gaussian normal-tilt perturbation of stddev
    sigma: mu*CDF(mu/s) + s*pdf(mu/s) with s = sigma*sin(incidence); CDF
    via the logistic approximation. Exactly max(mu, 0) as sigma -> 0."""
    s = sigma * torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0)) + 1e-6
    x = mu / s
    cdf = 1.0 / (1.0 + torch.exp(torch.clamp(-1.702 * x, -60.0, 60.0)))
    pdf = 0.39894228 * torch.exp(-0.5 * torch.clamp(x * x, max=120.0))
    return torch.clamp(mu * cdf + s * pdf, min=0.0)


def _acos_stable(x):
    return torch.atan2(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)


def _clip(x, lo, hi):
    # jnp.clip semantics (min(max(x, lo), hi)) with tensor bounds
    return torch.minimum(torch.maximum(x, lo), hi)


def sun_coverage(sep, r_sun, r_earth):
    """Fraction of the solar disk occulted by the Earth disk (flat-circle
    lens overlap; all args radians, tensors). Exactly 0 outside contact,
    exactly 1 in totality, smooth lens area between."""
    d = _clip(sep, torch.abs(r_earth - r_sun) + 1e-7, r_sun + r_earth - 1e-7)
    c1 = torch.clamp((d * d + r_sun * r_sun - r_earth * r_earth)
                     / (2.0 * d * r_sun), -1.0, 1.0)
    c2 = torch.clamp((d * d + r_earth * r_earth - r_sun * r_sun)
                     / (2.0 * d * r_earth), -1.0, 1.0)
    tri = ((-d + r_sun + r_earth) * (d + r_sun - r_earth)
           * (d - r_sun + r_earth) * (d + r_sun + r_earth))
    lens = (r_sun * r_sun * _acos_stable(c1)
            + r_earth * r_earth * _acos_stable(c2)
            - 0.5 * torch.sqrt(torch.clamp(tri, min=0.0)))
    cov = lens / (math.pi * r_sun * r_sun)
    cov = torch.where(sep >= r_sun + r_earth, 0.0, cov)
    cov = torch.where(sep <= r_earth - r_sun, 1.0, cov)
    return torch.clamp(cov, 0.0, 1.0)


def earth_light_terms(fp: FrameParams, p_body, n_body):
    """Earth-dependent light terms, or (None, None) when fp.earth is unset.

    Returns (eclipse_rgb, earthshine): eclipse_rgb is the (..., 3)
    multiplicative factor on direct solar irradiance (visible-sun fraction
    against the Earth disk + red refracted umbral light); earthshine is the
    (...,) additive term lighting the night side from the Earth. The sun
    side of the separation uses the Moon-center sun direction (see the
    reference's docstring for why)."""
    if fp.earth is None:
        return None, None
    light_body = mat3t_apply(fp.rotation, fp.light_pos)
    s_dir = normalize(light_body)
    e_vec = fp.earth[:3] * fp.earth[3] - p_body
    e_dir = normalize(e_vec)
    cosd = torch.sum(e_dir * s_dir, dim=-1)
    cross = torch.linalg.cross(e_dir, s_dir.expand_as(e_dir))
    sind = torch.sqrt(torch.clamp(torch.sum(cross * cross, dim=-1), min=0.0))
    sep = torch.atan2(sind, cosd)
    cov = sun_coverage(sep, fp.sun_ang_radius, fp.earth[4])
    f = 1.0 - cov
    tint = torch.tensor(C.UMBRA_TINT, dtype=torch.float32,
                        device=p_body.device)
    eclipse_rgb = f[..., None] + cov[..., None] * tint
    earthshine = fp.earth[5] * torch.clamp(
        torch.sum(n_body * e_dir, dim=-1), min=0.0)
    return eclipse_rgb, earthshine


def shade_lambert(albedo, n_body, p_body, fp: FrameParams, shadow,
                  sigma=None, bounce=None, view_db=None):
    """Diffuse shading with the area light's irradiance calibration.

    sigma: optional per-pixel normal-tilt stddev for roughness-compensated
    shading (see soft_ndotl). bounce: optional one-bounce terrain
    irradiance (ops.shadow_scan.bounce_from_parts units: adds to
    n.l * shadow before the irradiance scale). view_db: per-pixel unit ray
    directions in the body frame; required for the lunar-Lambert blend
    (fp.lunar_blend), ignored otherwise."""
    light_body = mat3t_apply(fp.rotation, fp.light_pos)
    to_light = normalize(light_body - p_body)
    mu = torch.sum(n_body * to_light, dim=-1)
    if sigma is None:
        ndotl = torch.clamp(mu, min=0.0)
    else:
        ndotl = torch.where(sigma > 1e-6, soft_ndotl(mu, sigma),
                            torch.clamp(mu, min=0.0))
    if fp.lunar_blend is not None and view_db is not None:
        # lunar-Lambert (McEwen): L*2*mu0/(mu0+mu_e) + (1-L)*mu0, with
        # mu_e = cos(emission) = -n.view; L=0 degenerates to exact Lambert
        mu_e = torch.clamp(-torch.sum(n_body * view_db, dim=-1), min=0.02)
        ls = 2.0 * ndotl / (ndotl + mu_e + 1e-6)
        ndotl = fp.lunar_blend * ls + (1.0 - fp.lunar_blend) * ndotl
    term = ndotl * shadow
    if bounce is not None:
        term = term + bounce
    rgb = albedo * (fp.irradiance * term)[..., None]
    ecl, earthshine = earth_light_terms(fp, p_body, n_body)
    if ecl is not None:
        rgb = rgb * ecl + albedo * (fp.irradiance * earthshine)[..., None]
    return rgb


def sun_disk_hit(eye, dirs_scene, fp: FrameParams):
    """Analytic visible-Sun-disk test in scene frame (flat white sphere,
    never shadow-casting)."""
    oc = eye[None, None, :] - fp.sun_disk_center[None, None, :]
    b = torch.sum(oc * dirs_scene, dim=-1)
    cc = torch.sum(oc * oc, dim=-1) - fp.sun_disk_radius ** 2
    return (b * b - cc > 0.0) & (b < 0.0)


def accumulate(accum, frame_rgb, n):
    """Running mean: accum + (frame - accum) / (n + 1)."""
    return accum + (frame_rgb - accum) / (n + 1.0)


def tonemap(rgb_linear, exposure: float, gamma: float):
    """Exposure + gamma to display uint8 (reference moon_renderer.py:452-454)."""
    exposure = torch.tensor(exposure, dtype=torch.float32)
    gamma = torch.tensor(gamma, dtype=torch.float32)
    x = torch.clamp(rgb_linear * exposure.to(rgb_linear.device), 0.0, 1.0)
    x = x ** (1.0 / gamma).to(rgb_linear.device)
    return (x * 255.0 + 0.5).to(torch.uint8)
