"""dc_roofline.batch: kernel C's (``pq_scan_kernel``) share of its
roofline over the traced window, in %: the bytes bound of the window's
work (``annbench.roofline.dc_bytes_ops``: a task per served query and
probe, the rows those probes hold by the drawn index's sizes) over the
kernel's device time."""

from annbench import roofline


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n, s = tr.kernel_time(lambda k: "pq_scan_kernel" in k)
    if n == 0 or s <= 0:
        return None
    svc = ctx.cell.config["service"]
    t = ctx.window.answered * svc["nprobe"]
    bound = roofline.bound_s(*roofline.dc_bytes_ops(
        t, svc["index"]["m"], svc["index"]["cb"], ctx.scanned_rows()))
    return 100.0 * bound / s
