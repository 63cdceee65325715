"""The yardstick of a kernel's roofline share: the card's peaks and the
byte counts every bound shares.

A kernel's least time is the larger of the bytes it must move at the
card's memory rate and the operations it must do at its float32 rate:
each input byte read once, each distinct texel that its windows cut from
a level read once (with all its channels), each output byte written once,
whatever the kernel reads again. Its roofline share is that least time
over its measured device time. Copied from the port's chip_smoke.py
(HBM_BYTES_PER_S, F32_FLOPS_PER_S, touched_bytes, nbytes at commit
41cfce49f52c); each kernel's own count lives beside its reader under
portbench/metrics/.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def touched_bytes(levels, lvl_idx, r0, c0, wh: int, ww: int) -> int:
    """Bytes of the distinct texels that per-block (wh, ww) windows cut
    from their levels (a texel read by several windows counts once, with
    all its channels). ``levels`` is one pyramid or several (maps)."""
    import torch

    if not isinstance(levels[0], torch.Tensor):
        return sum(touched_bytes(m, lvl_idx, r0, c0, wh, ww)
                   for m in levels)
    lvl_idx = torch.clamp(lvl_idx, 0, len(levels) - 1)
    total = 0
    for k, lvl in enumerate(levels):
        sel = lvl_idx == k
        if not bool(sel.any()):
            continue
        h, w = lvl.shape[0], lvl.shape[1]
        rr = torch.clamp(r0[sel].long(), 0, h - 1)
        cc = torch.clamp(c0[sel].long(), 0, w - 1)
        diff = torch.zeros((h + 1, w + 1), dtype=torch.int32,
                           device=lvl.device)
        ones = torch.ones_like(rr, dtype=torch.int32)
        r1 = torch.clamp(rr + wh, max=h)
        c1 = torch.clamp(cc + ww, max=w)
        for ri, ci, sign in ((rr, cc, 1), (rr, c1, -1), (r1, cc, -1),
                             (r1, c1, 1)):
            diff.index_put_((ri, ci), sign * ones, accumulate=True)
        cover = diff.cumsum(0).cumsum(1)[:h, :w] > 0
        total += int(cover.sum()) * lvl.element_size() * (
            lvl.shape[2] if lvl.ndim == 3 else 1)
    return total


def least_ms(n_bytes: float, n_ops: float) -> float:
    """The least milliseconds for this many bytes and float32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S) * 1e3


def share(calls: list, device_ms: float, count) -> float | None:
    """Roofline share in % of a kernel over its launches ``calls`` (wrapper
    name, arguments): the sum of ``count(call) -> (bytes, ops)``'s least
    times over the device time they took. None without device time."""
    if not calls or device_ms <= 0.0:
        return None
    least = sum(least_ms(*count(call)) for call in calls)
    return 100.0 * least / device_ms
