"""Shadow prefix-max + penumbra factor (K3).

Port of moonrtx_tpu/ops/shadow_prefix.py. Every scan-grid point is lit
iff its sun-aligned cylindrical radius ``m = R*h*sin(theta)`` exceeds the
running max of ``m`` over the earlier rows of its sun meridian; the
penumbra factor comes from the horizon elevation of the tallest blocker
against the solar angular radius. The TPU kernel carried the
per-meridian max across sequential grid steps; on Hopper theta is split
into chunks of CHUNK_ROWS rows across thread blocks: one pass folds each
chunk of a column to its first strict maximum, a second folds the chunks
above its own and walks its rows (csrc/shadow_prefix.cu). The combine is
associative, so the result equals the sequential walk bit for bit.

Tie rule: strict ``>`` keeps the EARLIER element (the reference's
_argmax_combine); the running max starts at -1.0 (heights are positive
and sin(theta) >= 0 on the scan band, so -1 is the identity).
"""

from __future__ import annotations

import ctypes

import torch

from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.ops.march_shade import atan2_poly

CHUNK_ROWS = 32   # theta rows a thread walks; the kernel takes 16, 32, 64


def prefix_ok(n_theta: int, n_phi: int) -> bool:
    """True for the scan-grid shapes the reference kernel tiles (theta a
    multiple of 128, phi a multiple of 128); the port keeps the same
    contract so both packages take the same path."""
    return n_theta % 128 == 0 and n_phi % 128 == 0


def _shift_down(x, d: int, fill: float):
    """x[i] -> x[i-d] along rows; rows with no source get ``fill``."""
    pad = torch.full((d,) + x.shape[1:], fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[:-d]], dim=0)


def shadow_factor_plain(hs, st, ct, sun_ang_radius: float,
                        moon_radius: float):
    """Plain PyTorch version of shadow_factor: a Hillis-Steele inclusive
    max-by-key scan over whole columns (log2(n_theta) shift/select
    passes, strict > so the earlier element wins ties), shifted to the
    exclusive scan, then the factor."""
    r = moon_radius * hs
    m = r * st
    z = r * ct
    im, iz = m, z
    d = 1
    while d < m.shape[0]:
        sm = _shift_down(im, d, -1.0)
        sz = _shift_down(iz, d, 0.0)
        keep = im > sm
        im = torch.where(keep, im, sm)
        iz = torch.where(keep, iz, sz)
        d *= 2
    m_max = _shift_down(im, 1, -1.0)
    z_at = _shift_down(iz, 1, 0.0)
    dz = torch.clamp(z_at - z, min=1e-6)
    alpha = atan2_poly(m_max - m, dz)
    sar = torch.tensor(sun_ang_radius, dtype=torch.float32, device=hs.device)
    factor = torch.clamp(0.5 - alpha / (2.0 * sar), 0.0, 1.0)
    return torch.where(m_max < 0.0, 1.0, factor)


@kernels.register("shadow_prefix", "mrtx_shadow_factor",
                  (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float,
                                            ctypes.c_int),
                  passes=("shadow_chunk_max_kernel", "shadow_factor_kernel"),
                  plain=shadow_factor_plain,
                  replaces="moonrtx_tpu/ops/shadow_prefix.py:120")
def shadow_factor(hs, st, ct, sun_ang_radius: float, moon_radius: float):
    """Penumbra factor map from scan-grid heights (K3, two passes over
    theta chunks on the card).

    Replaces moonrtx_tpu/ops/shadow_prefix.py::shadow_factor_tpu.
    hs: (n_theta, n_phi) f32 heights on the sun-frame scan grid;
    st/ct: (n_theta, 1) f32 sin/cos of each row's colatitude;
    sun_ang_radius: radians. Returns (n_theta, n_phi) f32:
    clip(0.5 - atan2(m_max - m, max(z_at - z, 1e-6)) / (2 sar), 0, 1),
    and 1 where no earlier row exists (m_max < 0).
    """
    call = dict(locals())
    n_theta, n_phi = hs.shape
    for t in (st, ct):
        if t.shape != (n_theta, 1) or t.dtype != torch.float32:
            raise ValueError("st/ct must be (n_theta, 1) f32")
    if hs.dtype != torch.float32 or hs.ndim != 2:
        raise ValueError("hs must be 2-D f32")
    if not (hs.device == st.device == ct.device):
        raise ValueError("hs/st/ct must share a device")
    if hs.device.type != "cuda":
        return shadow_factor_plain(hs, st, ct, sun_ang_radius, moon_radius)
    hs, st, ct = hs.contiguous(), st.contiguous(), ct.contiguous()
    out = torch.empty_like(hs)
    # per chunk and column, the (m, z) of the chunk's first strict maximum
    chunks = -(-n_theta // CHUNK_ROWS)
    scratch = torch.empty((2, chunks, n_phi), dtype=torch.float32,
                          device=hs.device)
    kernels.launch(shadow_factor,
                   (hs.data_ptr(), st.data_ptr(), ct.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), n_theta, n_phi,
                    float(moon_radius), float(sun_ang_radius), CHUNK_ROWS),
                   out, call)
    return out
