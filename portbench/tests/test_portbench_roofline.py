"""The roofline counts against hand counts at a small shape."""

import pytest
import torch

from harness import roofline, spec


def test_touched_bytes_counts_each_texel_once():
    lvl = torch.zeros((10, 12), dtype=torch.int16)
    # three 2x3 windows: two overlap in one row of three texels
    r0 = torch.tensor([0, 1, 6], dtype=torch.int32)
    c0 = torch.tensor([0, 0, 9], dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    texels = 6 + 6 - 3 + 6
    assert roofline.touched_bytes([lvl], idx, r0, c0, 2, 3) == texels * 2


def test_touched_bytes_channels_levels_and_maps():
    l0 = torch.zeros((8, 8, 3), dtype=torch.uint8)
    l1 = torch.zeros((4, 4, 3), dtype=torch.uint8)
    r0 = torch.tensor([0, 2], dtype=torch.int32)
    c0 = torch.tensor([0, 2], dtype=torch.int32)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    one = roofline.touched_bytes([l0, l1], idx, r0, c0, 2, 2)
    assert one == (4 + 4) * 3
    assert roofline.touched_bytes(([l0, l1], [l0, l1]), idx, r0, c0, 2,
                                  2) == 2 * one


def test_least_time_is_the_larger_bound():
    b = roofline.HBM_BYTES_PER_S
    f = roofline.F32_FLOPS_PER_S
    assert roofline.least_ms(b, 0) == pytest.approx(1e3)
    assert roofline.least_ms(0, f) == pytest.approx(1e3)
    assert roofline.least_ms(b, 2 * f) == pytest.approx(2e3)


def test_share_never_reads_zero():
    assert roofline.share([], 1.0, lambda c: (1, 1)) is None
    assert roofline.share([{}], 0.0, lambda c: (1, 1)) is None
    ms = roofline.least_ms(335e6, 0)                  # 0.1 ms of bytes
    assert roofline.share([{}, {}], 4 * ms,
                          lambda c: (335e6, 0)) == pytest.approx(50.0)


def load_reader_module(name):
    import importlib.util

    path = spec.ROOT / "portbench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_k1_count_by_hand():
    """extract.roofline.view's count on one group of 8 blocks of 2x3
    windows from one int16 level (the wrapper's plain version here)."""
    mod = load_reader_module("extract.roofline.view")
    lvl = torch.arange(10 * 12, dtype=torch.int16).reshape(10, 12)
    r0 = torch.tensor([0, 0, 0, 0, 4, 4, 8, 8], dtype=torch.int32)
    c0 = torch.tensor([0, 3, 6, 9, 0, 1, 0, 9], dtype=torch.int32)
    call = dict(map_levels=((lvl,),), lvl_idx=torch.zeros(8, dtype=torch.int32),
                r0=r0, c0=c0, wh=2, ww=3)
    by, ops = mod.count(call)
    # rows 0-1: four windows side by side, 24 texels; rows 4-5: columns
    # 0-3, 8 texels; rows 8-9: columns 0-2 and 9-11, 12 texels
    texels = 24 + 8 + 12
    out = 8 * 2 * 3 * 4                                 # f32 windows
    assert by == texels * 2 + 3 * 8 * 4 + out
    assert ops == 2 * 8 * 2 * 3
