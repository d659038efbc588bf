"""lc_roofline.batch: kernel A's (``lut_build_kernel``) share of its
roofline over the traced window, in %: the larger of the bytes and the
operations bound of the window's work (``annbench.roofline.
lut_bytes_ops``: a residual row per served query and probe, the
codebooks read once a launch) over the kernel's device time."""

from annbench import roofline


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n, s = tr.kernel_time(lambda k: "lut_build_kernel" in k)
    if n == 0 or s <= 0:
        return None
    cfg = ctx.cell.config
    svc = cfg["service"]
    m, cb = svc["index"]["m"], svc["index"]["cb"]
    t = ctx.window.answered * svc["nprobe"]
    bound = roofline.bound_s(*roofline.lut_bytes_ops(
        t, m, cb, cfg["dim"] // m, launches=n))
    return 100.0 * bound / s
