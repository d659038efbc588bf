"""dc_u8_roofline.batch: kernel D's share of its roofline over the traced
window, in %: the bytes bound of the window's work (``annbench.
roofline_u8.dc_u8_bytes_ops``: a task per served query and probe, the
rows those probes hold by the drawn index's sizes) over D's device time.
D is the instance of ``pq_scan_kernel`` whose table kind (its second
template argument) is 1, the uint8 table; C's and the bf16 table's
launches are not read."""

import re

from annbench import roofline, roofline_u8

D = re.compile(r"pq_scan_kernel<[^<>,]+,\s*1\s*,")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n, s = tr.kernel_time(lambda k: bool(D.search(k)))
    if n == 0 or s <= 0:
        return None
    svc = ctx.cell.config["service"]
    t = ctx.window.answered * svc["nprobe"]
    bound = roofline.bound_s(*roofline_u8.dc_u8_bytes_ops(
        t, svc["index"]["m"], svc["index"]["cb"], ctx.scanned_rows()))
    return 100.0 * bound / s
