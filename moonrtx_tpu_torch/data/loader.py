"""Data ingest: elevation, color, star map.

Reproduces the reference's processing semantics (data_loader.py):

* LOLA LDEM TIFF -> int16 reinterpret -> 0.5 m/unit / 1737.4 km -> block-mean
  downscale -> +1.0 -> peak-normalized so max == 1.0 (the displaced surface
  must stay inside the bounding sphere, data_loader.py:136-140,188-190),
  returning (elevation, radius_scale),
* color TIFF -> RGB linear reflectance,
* star map -> resized RGB float,
* fingerprinted .npy caches with silent fallback (data_loader.py:19-49).

When a source file is absent the loaders fall back to procedural synthesis
(moonrtx_tpu_torch.data.synth) instead of aborting, so the framework is fully
functional without the ~9 GB download. The block-mean hot loop can use the
native C++ path (moonrtx_tpu_torch.native) when it builds.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.data import cache, synth
from moonrtx_tpu_torch.data.mips import block_mean

SYNTH_CACHE_DIR = os.environ.get(
    "MOONRTX_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "moonrtx_tpu")
)
SYNTH_ELEVATION_SHAPE = (2880, 5760)


def _native_block_mean(a: np.ndarray, factor: int) -> np.ndarray:
    """Use the multithreaded C++ downscaler when available."""
    try:
        from moonrtx_tpu_torch.native import bindings
        return bindings.block_mean_int16(a, factor)
    except Exception:
        return block_mean(a.astype(np.float32), factor)


def _synth_cache(name: str, maker, *shape_args) -> np.ndarray:
    os.makedirs(SYNTH_CACHE_DIR, exist_ok=True)
    path = os.path.join(SYNTH_CACHE_DIR, name + ".npy")
    try:
        # memory-mapped: consumers that hit the downstream pyramid cache
        # (data.pyramids) never read most of the array
        return np.load(path, mmap_mode="r")
    except Exception:
        pass
    arr = maker(*shape_args)
    try:
        np.save(path, arr)
    except Exception as e:
        print(f"Warning: could not cache {path}: {e}")
    return arr


def _synth_cache_streamed(name: str, shape, writer) -> np.ndarray:
    """_synth_cache for outputs too big to materialize: `writer(out)`
    fills a w+ open_memmap in row bands (flushing pages behind itself),
    so the host peak stays O(band).  Falls back silently to a later
    in-memory maker only by raising — callers pair it with a maker
    branch when the streamed preconditions do not hold."""
    os.makedirs(SYNTH_CACHE_DIR, exist_ok=True)
    path = os.path.join(SYNTH_CACHE_DIR, name + ".npy")
    try:
        return np.load(path, mmap_mode="r")
    except Exception:
        pass
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                        shape=tuple(shape))
        writer(out)
        synth.flush_drop_pages(out)
        del out
        os.replace(tmp, path)
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return np.load(path, mmap_mode="r")


def _synth_moon_cached(h: int, w: int, want: str) -> np.ndarray:
    """Fetch the synthesized elevation or albedo, generating BOTH in one
    pass (synthesize_moon produces the pair; caching them together halves
    the expensive first run)."""
    os.makedirs(SYNTH_CACHE_DIR, exist_ok=True)
    paths = {
        "elev": os.path.join(SYNTH_CACHE_DIR, f"synth_elev_{h}x{w}_s7v2.npy"),
        "color": os.path.join(SYNTH_CACHE_DIR, f"synth_color_{h}x{w}_s7v2.npy"),
    }
    try:
        return np.load(paths[want])
    except Exception:
        pass
    elev, albedo = synth.synthesize_moon(h, w)
    for key, arr in (("elev", elev), ("color", albedo)):
        try:
            np.save(paths[key], arr)
        except Exception as e:
            print(f"Warning: could not cache {paths[key]}: {e}")
    return elev if want == "elev" else albedo


def _synth_norm_streamed(base: str, writer, shape) -> tuple[np.ndarray, float]:
    """Write the raw synth elevation straight into the cache file via an
    open_memmap, then normalize it in place in row bands — no full-map
    host copy ever exists (the in-memory path peaked ~8.5 GB at the bench
    working set on the upsample + divide + save alone; the cold-synthesis
    host-RSS cap)."""
    import json

    tmp = f"{base}.{os.getpid()}.tmp.npy"
    try:
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32,
                                        shape=tuple(shape))
        writer(out)
        band = max((64 << 20) // (out.shape[1] * 4), 1)
        radius_scale = -np.inf
        for i, r in enumerate(range(0, out.shape[0], band)):
            radius_scale = max(radius_scale, float(np.max(out[r:r + band])))
            if i % 16 == 15:
                synth.flush_drop_pages(out)  # clean refaults, keep RSS flat
        for i, r in enumerate(range(0, out.shape[0], band)):
            # same expression as the in-memory path (f32 array / python
            # float), so the two paths produce identical bytes
            out[r:r + band] /= radius_scale
            if i % 4 == 3:
                synth.flush_drop_pages(out)
        synth.flush_drop_pages(out)
        del out
        os.replace(tmp, base + ".npy")
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    with open(base + ".json", "w", encoding="utf-8") as f:
        json.dump({"radius_scale": radius_scale}, f)
    return np.load(base + ".npy", mmap_mode="r"), radius_scale


def _synth_norm_cached(name: str, maker, banded_writer=None,
                       shape=None) -> tuple[np.ndarray, float]:
    """Normalized (max == 1.0) synth elevation + radius_scale, cached.

    The array loads memory-mapped: consumers that hit the downstream
    pyramid cache (data.pyramids) never read most of it.  When
    banded_writer + shape are given (multi-gigatexel upsample targets),
    generation streams through _synth_norm_streamed instead of
    materializing maker()'s full array."""
    import json

    os.makedirs(SYNTH_CACHE_DIR, exist_ok=True)
    base = os.path.join(SYNTH_CACHE_DIR, name)
    try:
        with open(base + ".json", "r", encoding="utf-8") as f:
            meta = json.load(f)
        return (np.load(base + ".npy", mmap_mode="r"),
                float(meta["radius_scale"]))
    except Exception:
        pass
    if banded_writer is not None and shape is not None:
        try:
            return _synth_norm_streamed(base, banded_writer, shape)
        except Exception as e:
            print(f"Warning: streamed synthesis failed ({e}); "
                  "falling back to the in-memory path")
    elevation = maker()
    radius_scale = float(elevation.max())
    elevation = (elevation / radius_scale).astype(np.float32)
    try:
        np.save(base + ".npy", elevation)
        with open(base + ".json", "w", encoding="utf-8") as f:
            json.dump({"radius_scale": radius_scale}, f)
    except Exception as e:
        print(f"Warning: could not cache {base}.npy: {e}")
    return elevation, radius_scale


def load_elevation_data(filepath: Optional[str], downscale: int,
                        synth_shape: Optional[tuple[int, int]] = None
                        ) -> tuple[np.ndarray, float]:
    """(elevation displacement factors with max exactly 1.0, radius_scale).

    synth_shape: target dimensions for the procedural fallback. Shapes
    larger than the base synthesis grid are produced by detail-preserving
    upsampling (synth.upsample_elevation) and disk-cached — used to bench
    at the real LOLA LDEM working-set size (reference main.py:25-29).
    """
    if filepath and os.path.isfile(filepath):
        return _load_elevation_file(filepath, downscale)
    if filepath:
        print(f"Elevation file not found: {filepath} — using procedural synthesis.")
    else:
        print("No elevation file configured — using procedural synthesis.")
    h, w = SYNTH_ELEVATION_SHAPE
    if synth_shape is not None and tuple(synth_shape) != (h, w):
        th, tw = synth_shape
        if th % h or tw % w or th // h != tw // w:
            raise ValueError(
                f"synth_shape {synth_shape} must be an integer multiple "
                f"of the base grid {(h, w)}")
        def _make():
            return synth.upsample_elevation(
                _synth_moon_cached(h, w, "elev"), th // h)

        def _write(out):
            synth.upsample_elevation(
                _synth_moon_cached(h, w, "elev"), th // h, out=out)
        name = f"synth_elev_{th}x{tw}_up_s7v2"
        if downscale == 1:
            return _synth_norm_cached(name + "_norm", _make,
                                      banded_writer=_write, shape=(th, tw))
    else:
        def _make():
            return _synth_moon_cached(h, w, "elev")
        name = f"synth_elev_{h}x{w}_s7v2"
    if downscale > 1:
        elevation = block_mean(_make(), downscale)
        radius_scale = float(elevation.max())
        return (elevation / radius_scale).astype(np.float32), radius_scale
    # the normalized product is itself cached (with radius_scale in a
    # sidecar) and memory-mapped: at the full-LDEM working set the
    # max + divide passes alone cost ~2 min of host time per start
    return _synth_norm_cached(name + "_norm", _make)


def _load_elevation_file(filepath: str, downscale: int) -> tuple[np.ndarray, float]:
    import cv2

    print(f"Loading elevation data from {filepath}...")
    cache_base = f"{filepath}.ds{downscale}"
    fp = None
    if downscale > 1:
        fp = cache.fingerprint(filepath, downscale=downscale)
        elevation, meta = cache.load(cache_base, fp)
        if elevation is not None:
            print(f"  Loaded from cache: {cache_base}.npy, dimensions {elevation.shape}")
            return elevation, float(meta["radius_scale"])

    src = cv2.imread(filepath, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
    if src is None:
        raise ValueError(f"Failed to read elevation file: {filepath}")
    if src.ndim == 3:
        src = src[..., 0]
    # LDEM stores signed 16-bit values; readers often hand them back as uint16.
    if src.dtype == np.uint16:
        src = src.view(np.int16)
    print(f"  Original dimensions: {src.shape}, {src.nbytes / 1024**3:.2f} GB")

    scale = C.LDEM_METERS_PER_UNIT / C.MOON_REFERENCE_RADIUS_M
    if downscale == 1:
        elevation = src.astype(np.float32) * scale
    else:
        elevation = _native_block_mean(src, downscale) * scale
    del src

    elevation += 1.0
    print("  Relief range: {:.0f} m to {:+.0f} m relative to the reference radius".format(
        (elevation.min() - 1.0) * C.MOON_REFERENCE_RADIUS_M,
        (elevation.max() - 1.0) * C.MOON_REFERENCE_RADIUS_M))

    radius_scale = float(elevation.max())
    elevation = (elevation / radius_scale).astype(np.float32)

    if fp is not None:
        cache.save(cache_base, elevation, {**fp, "radius_scale": radius_scale})
    return elevation, radius_scale


def load_color_data(filepath: Optional[str], downscale: int = 1,
                    synth_shape: Optional[tuple[int, int]] = None
                    ) -> np.ndarray:
    """Linear RGB albedo, float32 (H, W, 3) in [0, 1].

    Real color maps get the reference's reflectance mapping
    0.2 + 0.75/255 * value (data_loader.py:222). Unlike the reference (which
    bakes gamma into a GPU texture) the engine keeps albedo linear and
    applies exposure/gamma in its own tone-map stage.
    """
    if filepath and os.path.isfile(filepath):
        import cv2

        print(f"Loading color data from {filepath}...")
        src = cv2.imread(filepath)
        if src is None:
            raise ValueError(f"Failed to read color file: {filepath}")
        rgb = src[..., ::-1].astype(np.float32)
        rgb = 0.2 + (0.75 / 255.0) * rgb
        if downscale > 1:
            rgb = block_mean(rgb, downscale)
        return np.ascontiguousarray(rgb)
    if filepath:
        print(f"Color file not found: {filepath} — using procedural synthesis.")
    h, w = SYNTH_ELEVATION_SHAPE
    albedo = _synth_moon_cached(h, w, "color")
    if synth_shape is not None and tuple(synth_shape) != (h, w):
        th, tw = synth_shape
        if th <= h:
            albedo = block_mean(albedo, h // th)
        else:
            src = albedo
            name = f"synth_color_{th}x{tw}_up_s7v2"

            def _mk():
                import cv2
                return np.clip(cv2.resize(
                    src, (tw, th), interpolation=cv2.INTER_CUBIC),
                    0.05, 0.95).astype(np.float32)
            albedo = None
            if th % h == 0 and tw % w == 0 and th // h == tw // w:
                try:
                    albedo = _synth_cache_streamed(
                        name, (th, tw, 3),
                        lambda out: synth.upsample_color(src, th // h,
                                                         out=out))
                except Exception as e:
                    print(f"Warning: streamed color upsample failed "
                          f"({e}); using the in-memory path")
            if albedo is None:
                albedo = _synth_cache(name, _mk)
    if downscale > 1:
        albedo = block_mean(albedo, downscale)
    return albedo


def load_starmap(filepath: Optional[str], target_width: int) -> Optional[np.ndarray]:
    """Star background, float32 (H, W, 3) in [0, 1], resized to target_width."""
    if filepath and os.path.isfile(filepath):
        import cv2

        print(f"Loading star map from {filepath}...")
        cache_base = f"{filepath}.w{target_width}"
        fp = cache.fingerprint(filepath, target_width=target_width)
        star_map, _ = cache.load(cache_base, fp)
        if star_map is not None:
            print(f"  Loaded from cache: {cache_base}.npy")
            return star_map
        src = cv2.imread(filepath)
        if src is None:
            print(f"Failed to read star map: {filepath}")
            return None
        star = src[..., ::-1].astype(np.float32) / 255.0
        if target_width < star.shape[1]:
            th = int(star.shape[0] * target_width / star.shape[1])
            star = cv2.resize(star, (target_width, th), interpolation=cv2.INTER_CUBIC)
            np.clip(star, 0.0, 1.0, out=star)
        cache.save(cache_base, star, fp)
        return star
    h = max(target_width // 2, 256)
    return _synth_cache(f"synth_stars_{h}x{2*h}_s11", synth.synthesize_starmap, h, 2 * h)
