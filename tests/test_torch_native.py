"""The port's native C++ data-pipeline kernels (host code): the cases of
tests/test_native.py against the numpy reference, the port's block mean
bit-equal to the JAX package's native one, and the loader's downscale
through it."""

import numpy as np
import pytest

from moonrtx_tpu_torch.data.mips import block_mean

native = pytest.importorskip("moonrtx_tpu_torch.native.bindings")

if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def test_block_mean_int16_matches_numpy():
    rng = np.random.default_rng(0)
    src = rng.integers(-5000, 5000, (96, 128), dtype=np.int16)
    out = native.block_mean_int16(src, 4)
    ref = block_mean(src.astype(np.float32), 4)
    assert out.shape == (24, 32)
    assert np.allclose(out, ref, atol=1e-3)


def test_block_mean_f32_matches_numpy():
    rng = np.random.default_rng(1)
    src = rng.random((60, 90)).astype(np.float32)
    out = native.block_mean_f32(src, 3)
    ref = block_mean(src, 3)
    assert np.allclose(out, ref, atol=1e-5)


def test_resample_bilinear_identity():
    rng = np.random.default_rng(2)
    src = rng.random((32, 64)).astype(np.float32)
    out = native.resample_bilinear_f32(src, 32, 64)
    assert np.allclose(out, src, atol=1e-5)


def test_resample_bilinear_downscale_energy():
    src = np.ones((64, 128), np.float32) * 0.7
    out = native.resample_bilinear_f32(src, 16, 32)
    assert np.allclose(out, 0.7, atol=1e-6)


def test_native_speed_beats_numpy():
    """The point of the native path: large int16 downscales faster than the
    numpy reshape-mean (reference's ~1 minute step)."""
    import time

    rng = np.random.default_rng(3)
    src = rng.integers(-5000, 5000, (4096, 8192), dtype=np.int16)
    t0 = time.perf_counter()
    out_n = native.block_mean_int16(src, 4)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = block_mean(src.astype(np.float32), 4)
    t_numpy = time.perf_counter() - t0
    assert np.allclose(out_n, ref, atol=1e-2)
    assert t_native < t_numpy * 1.5  # typically several times faster


def test_block_mean_int16_bit_equal_to_reference():
    ref_native = pytest.importorskip("moonrtx_tpu.native.bindings")
    if not ref_native.available():
        pytest.skip("the JAX package's native library does not build")
    rng = np.random.default_rng(4)
    src = rng.integers(-32768, 32767, (300, 600), dtype=np.int16)
    for factor in (2, 3, 4):
        np.testing.assert_array_equal(native.block_mean_int16(src, factor),
                                      ref_native.block_mean_int16(src,
                                                                  factor))


def test_library_builds_outside_the_package():
    """The port's library lands in build/native/, never beside the JAX
    package's libmoonrtx_native.so or inside the port's package."""
    import os

    path = native._lib_path()
    assert path.is_file()
    parts = path.parts
    assert parts[-3:-1][0] == "native" and parts[-4] == "build"
    assert not str(path).startswith(os.path.dirname(native.__file__))


def test_loader_downscales_through_the_native_path(monkeypatch):
    from moonrtx_tpu_torch.data import loader

    rng = np.random.default_rng(5)
    src = rng.integers(-5000, 5000, (64, 96), dtype=np.int16)
    got = loader._native_block_mean(src, 4)
    np.testing.assert_array_equal(got, native.block_mean_int16(src, 4))
    # without the library, the numpy block mean gives the same numbers
    monkeypatch.setattr(native, "_load", lambda: 1 / 0)
    np.testing.assert_allclose(loader._native_block_mean(src, 4), got,
                               atol=1e-3)
