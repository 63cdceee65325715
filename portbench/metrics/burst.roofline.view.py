"""burst.roofline.view: the burst kernel's share (%) of its roofline over
one view's burst launches (csrc/march_shade.cu, kernel ``burst_kernel``:
samples 1..N-1 of the view's accumulation in one launch).

The view is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts, from the recorded
arguments alone, less than the burst needs: the params, the chord
bounds, the jitters of its samples, sample 0's colour, hit distance and
hit mask and the three mean planes once; the height, scalar, albedo and
shadow windows of the strips with a hit in sample 0 once; and for each
of the N-1 warm samples K2's 360 flops a ray and 400 a hit (760) on the
rays that hit in sample 0 alone (chip_smoke.py's bound_of). The device
time is the probe's ``burst_kernel`` events; the name holds no
``march_kernel``, so march.roofline.view keeps reading K2 alone. A
program without the burst kernel records no such call, and the metric
is left out."""

from harness import roofline

WRAPPER = "march_burst"
KERNEL = "burst_kernel"


def count(call):
    hit = call["f_prev"] > 0.5
    ns = hit.shape[0]
    n_hit = int(hit.reshape(ns, -1).amax(dim=1).sum())   # strips with a hit
    planes = [call[k] for k in ("r", "g", "b", "t_prev", "f_prev")]
    by = roofline.nbytes(call["params"], call["jitters"][:call["n_samples"]],
                         *planes, *planes[:3])            # + the mean
    if call["h_bound"] is not None:
        by += roofline.nbytes(call["h_bound"])
    by += roofline.nbytes(call["scal"], call["hwin"], call["awin"],
                          call["swin"]) * n_hit // ns
    ops = (call["n_samples"] - 1) * 760 * int(hit.sum())
    return by, ops


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    return roofline.share(calls, probe["trace"].kernel_ms(KERNEL), count)
