"""march.roofline.view: K2's share (%) of its roofline over one view's
march-and-shade launches (csrc/march_shade.cu, kernel ``march_kernel``).

The view is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts what the frame needs:
per launch the rays' inputs and the outputs once (8 channels a ray), the
height and scalar windows of the strips with a live ray and the albedo
and shadow windows of the strips with a hit, once each; at least 6 field
evaluations of ~60 flops per ray and ~400 flops of normal and shading per
hit ray (chip_smoke.py's bound_of, copied at commit 41cfce49f52c). The
device time is the probe's ``march_kernel`` events."""

from harness import roofline

WRAPPER = "march_shade"
KERNEL = "march_kernel"


def count(call):
    from moonrtx_tpu_torch import kernels

    out = kernels.wrappers()[WRAPPER](**call)
    act = call["active"].reshape(call["active"].shape[0], -1)
    live = act.amax(dim=1) > 0.5                # strips with a live ray
    hit = out[3].reshape(out[3].shape[0], -1).amax(dim=1) > 0.5
    n_live, n_hit = int(live.sum()), int(hit.sum())
    ns = act.shape[0]
    rays = [call[k] for k in ("dbx", "dby", "dbz", "t_enter", "t_end",
                              "active")]
    if call["t_prev"] is not None:
        rays += [call["t_prev"], call["f_prev"]]
    by = roofline.nbytes(call["params"], *rays, *out)
    by += (roofline.nbytes(call["scal"], call["hwin"])) * n_live // ns
    by += (roofline.nbytes(call["awin"], call["swin"])) * n_hit // ns
    ops = 360 * act.numel() + 400 * int((out[3] > 0.5).sum())
    return by, ops


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    return roofline.share(calls, probe["trace"].kernel_ms(KERNEL), count)
