"""Device lists and the explicit collectives between them (torch).

Port of moonrtx_tpu/parallel/mesh.py. The reference drives a 1-D JAX mesh
from one process and lets shard_map run one program per image strip. Here
one process drives an explicit list of devices: each strip's tensors live
on its own device, the host issues the strips in turn with no
synchronisation between them, and the reference's collectives are
explicit copies and sums (all_gather, reduce_scatter, broadcast below).

A "sharded" value is a list of per-device tensors in device order (or a
NamedTuple whose fields are such lists, ``shard`` picks one device's
tuple). A replicated input is passed as one tensor and moved to each
device where it is used (a no-op where it already lives there).

On the CPU the devices are n logical CPU devices (the counterpart of the
reference's virtual CPU mesh). On a host with fewer cards than asked the
caller may ask explicitly for n logical devices on one card
(``virtual=True``); nothing ever builds a smaller mesh than asked.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE_AXIS = "tiles"


class Mesh(NamedTuple):
    """An ordered list of devices, one image strip (and one phi wedge,
    one heightfield band) per entry. ``virtual``: several entries share a
    card."""

    devices: tuple
    virtual: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """{TILE_AXIS: n}, the reference Mesh's shape."""
        return {TILE_AXIS: len(self.devices)}

    def sharing(self, device) -> int:
        """How many logical devices of the mesh live on ``device``."""
        return sum(1 for d in self.devices if d == torch.device(device))


def make_mesh(n_devices: Optional[int] = None, device=None,
              virtual: bool = False) -> Mesh:
    """A mesh of n devices (default: every card, or one CPU device).

    ``device`` "cpu" gives n logical CPU devices; otherwise (None or
    "cuda") cards cuda:0..n-1. Raises when fewer than n cards exist
    unless ``virtual`` is passed, in which case the n logical devices all
    live on cuda:0: a silent smaller mesh would make every multi-device
    check vacuously single-device."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        return Mesh(tuple(torch.device("cpu") for _ in range(n)))
    if kind != "cuda":
        raise ValueError(f"make_mesh: unsupported device type {kind!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1:
        raise RuntimeError("make_mesh: no CUDA device is available")
    if have < n:
        if not virtual or have < 1:
            raise RuntimeError(
                f"make_mesh({n}): only {have} CUDA device(s) available; "
                f"pass virtual=True to run {n} logical devices on one card, "
                "or device='cpu' for logical CPU devices")
        return Mesh(tuple(torch.device("cuda", 0) for _ in range(n)),
                    virtual=True)
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def to_device(x, device):
    """``x`` (a tensor, None, a number, or a (Named)tuple of them) with
    every tensor moved to ``device``."""
    if x is None or isinstance(x, (int, float, bool)):
        return x
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        vals = [to_device(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    raise TypeError(f"to_device: unsupported {type(x).__name__}")


def shard(x, d: int):
    """Device d's part of a sharded value: x[d] of a list, the tuple of
    every field's d-th entry of a NamedTuple of lists; anything else is
    replicated and returned as it is."""
    if isinstance(x, list):
        return x[d]
    if isinstance(x, tuple) and hasattr(x, "_fields") and any(
            isinstance(v, list) for v in x):
        return type(x)(*[shard(v, d) for v in x])
    return x


def stack_shards(parts: list):
    """The NamedTuple of per-device lists from per-device NamedTuples
    (the inverse of ``shard`` over every d)."""
    first = parts[0]
    return type(first)(*[[p[i] for p in parts]
                         for i in range(len(first))])


def replicated(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` on every device of the mesh (the tensor itself where it
    already lives there): the reference's replicated placement."""
    return broadcast(t, mesh)


def row_sharded(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` split by rows (dim 0) into equal parts, part d on device d:
    the reference's row-sharded placement."""
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"row_sharded: {t.shape[0]} rows do not divide "
                         f"over {n} devices")
    return [p.to(dev) for p, dev in zip(torch.chunk(t, n, dim=0),
                                        mesh.devices)]


def broadcast(t: torch.Tensor, mesh: Mesh) -> list:
    """One tensor copied to every device of the mesh, in device order
    (no copy on a device that already holds it)."""
    return [t.to(dev) for dev in mesh.devices]


def all_gather(parts: list, dim: int, to) -> torch.Tensor:
    """Concatenate the per-device parts along ``dim`` on device ``to``:
    the reference's tiled all-gather, collected on one device."""
    return torch.cat([p.to(to) for p in parts], dim=dim)


def reduce_scatter(parts: list, dim: int) -> list:
    """Device d receives the sum over every device s of slice d of
    parts[s] along ``dim`` (parts[s] is split into len(parts) equal
    slices): the reference's tiled psum_scatter. The sum runs on device d
    in device order."""
    n = len(parts)
    if parts[0].shape[dim] % n:
        raise ValueError(f"reduce_scatter: size {parts[0].shape[dim]} does "
                         f"not divide over {n} devices")
    chunks = [torch.chunk(p, n, dim=dim) for p in parts]
    out = []
    for d in range(n):
        dev = parts[d].device
        acc = chunks[0][d].to(dev).clone()
        for s in range(1, n):
            acc += chunks[s][d].to(dev)
        out.append(acc)
    return out
