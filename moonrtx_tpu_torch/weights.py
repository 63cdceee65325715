"""Scene state carried across from numpy arrays.

The port's scene state is its device pyramids and a few scalars (there
are no learned weights). ``scene_state_from_numpy`` turns host arrays —
for instance ``np.asarray`` of a reference ``moonrtx_tpu`` MoonScene's
device arrays — into the flat tensor dict that ``MoonScene.load_state``
installs, so both packages can be shown to compute on identical state.
``tuple_from_numpy`` does the same for the blocked pipeline's pose
caches and per-frame tuples (WindowOrigins, WindowCache, ShadowWindows,
RayGeom, FrameParams, ShadowMapParams, CameraBasis): the fields of the
other package's tuple, as numpy, become the port's tuple of tensors.
``per_device_from_shards`` carries sharded state across: an array split
over a device mesh (anything with ``addressable_shards``, such as a JAX
array laid out by a mesh), or a NamedTuple of them (WindowOrigins,
WindowCache, PackedWindows), becomes the port's per-device lists
(parallel/mesh.py), so cached mesh state compares device by device.
"""

from __future__ import annotations

import numpy as np
import torch

LEVEL_KEYS = ("mips", "albedo_mips")
ARRAY_KEYS = ("maxmap", "slope_maps", "starmap")
FLOAT_KEYS = ("h_min", "h_scale", "h_offset", "a_scale")


def scene_state_from_numpy(arrays: dict) -> dict[str, torch.Tensor]:
    """Flat {name: tensor} scene state from host arrays.

    arrays: "mips" and "albedo_mips" (sequences of 2-D / 3-D level
    arrays), "maxmap", "slope_maps", optional "starmap" (the padded star
    map or None), float scalars "h_min", "h_scale", "h_offset",
    "a_scale" and the int "alb_min_level". Levels become "mips.0",
    "mips.1", ...; scalars become 0-d float64/int64 tensors, so no
    precision is lost. Tensors are on the CPU; load_state moves them."""
    state: dict[str, torch.Tensor] = {}
    for key in LEVEL_KEYS:
        for i, a in enumerate(arrays[key]):
            state[f"{key}.{i}"] = torch.from_numpy(np.array(a, copy=True))
    for key in ARRAY_KEYS:
        a = arrays.get(key)
        if a is not None:
            state[key] = torch.from_numpy(np.array(a, copy=True))
    for key in FLOAT_KEYS:
        state[key] = torch.tensor(float(arrays[key]), dtype=torch.float64)
    state["alb_min_level"] = torch.tensor(int(arrays["alb_min_level"]),
                                          dtype=torch.int64)
    return state


def tuple_from_numpy(cls, fields: dict, device="cpu"):
    """The port's NamedTuple ``cls`` from a {field: numpy array or None}
    dict (for instance ``ref._asdict()`` of the reference's tuple of the
    same name, each array through ``np.asarray``). Dtypes are kept
    (float32, int32, bool); a float64 scalar becomes float32, the device
    type of every such field. Fields the dict lacks take the tuple's
    default."""
    out = {}
    for name in cls._fields:
        if name not in fields:
            continue
        v = fields[name]
        if v is None:
            out[name] = None
            continue
        a = np.array(v, copy=True)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(a).to(device)
    return cls(**out)


def per_device_from_shards(x):
    """The port's per-device lists from a sharded array: one CPU tensor
    per addressable shard, in device order (by the shard's offset along
    the leading axis, then its device id). An array without shards
    becomes a one-entry list; None stays None. A NamedTuple of such
    arrays becomes the same NamedTuple with a list per field. Dtypes are
    kept (bfloat16 too), float64 becomes float32 as in
    tuple_from_numpy."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return type(x)(*(per_device_from_shards(v) for v in x))
    shards = getattr(x, "addressable_shards", None)
    if shards is None:
        parts = [x]
    else:
        def order(s):
            first = s.index[0] if len(s.index) else slice(None)
            return (first.start or 0, s.device.id)
        parts = [s.data for s in sorted(shards, key=order)]
    out = []
    for p in parts:
        a = np.array(p, copy=True)
        if a.dtype.name == "bfloat16":  # numpy has no bf16: via f32, exact
            out.append(torch.from_numpy(a.astype(np.float32))
                       .to(torch.bfloat16))
            continue
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out.append(torch.from_numpy(a))
    return out
