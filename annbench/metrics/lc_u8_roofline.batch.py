"""lc_u8_roofline.batch: kernel B's share of its roofline over the traced
window, in %: the larger of the bytes and the operations bound of the
window's work (``annbench.roofline_u8.lut_u8_bytes_ops``: a residual row
per served query and probe, the codebooks read once a launch) over B's
device time.  B is the instance of ``lut_build_kernel`` whose last
template argument (``kOut``) is 1, the uint8 table; A's and the bf16
table's launches are not read."""

import re

from annbench import roofline, roofline_u8

B = re.compile(r"lut_build_kernel<[^<>]*,\s*1\s*>")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n, s = tr.kernel_time(lambda k: bool(B.search(k)))
    if n == 0 or s <= 0:
        return None
    cfg = ctx.cell.config
    svc = cfg["service"]
    m, cb = svc["index"]["m"], svc["index"]["cb"]
    t = ctx.window.answered * svc["nprobe"]
    bound = roofline.bound_s(*roofline_u8.lut_u8_bytes_ops(
        t, m, cb, cfg["dim"] // m, launches=n))
    return 100.0 * bound / s
