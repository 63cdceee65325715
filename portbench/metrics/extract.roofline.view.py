"""extract.roofline.view: K1's share (%) of its roofline over one view's
pose-window extractions (csrc/extract.cu, kernel ``extract_group_kernel``).

The view is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts each distinct texel the
blocks' windows cut from the levels once (all its channels), the origins
and level indices, and the windows written once; two flops a texel for the
decode (chip_smoke.py's bound_of, copied at commit 41cfce49f52c). The
device time is the probe's ``extract_group_kernel`` events."""

from harness import roofline

WRAPPER = "extract_group_windows"
KERNEL = "extract_group_kernel"


def count(call):
    from moonrtx_tpu_torch import kernels

    out = kernels.wrappers()[WRAPPER](**call)
    by = roofline.touched_bytes(call["map_levels"], call["lvl_idx"],
                                call["r0"], call["c0"], call["wh"],
                                call["ww"])
    by += roofline.nbytes(call["lvl_idx"], call["r0"], call["c0"], out)
    return by, 2 * out.numel()


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    return roofline.share(calls, probe["trace"].kernel_ms(KERNEL), count)
