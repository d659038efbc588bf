"""topk_share.batch: the share, in %, of the traced window's kernel time
spent in the top-k and sort kernels ``torch.topk`` launches (CL's
top-nprobe and TS), by the kernel names the profiler reports."""

import re

TOPK = re.compile(r"topk|sort|radix|kthvalue|bitonic", re.IGNORECASE)


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.kernel_s <= 0:
        return None
    _, s = tr.kernel_time(lambda n: bool(TOPK.search(n))
                          and "pq_scan" not in n)
    return 100.0 * s / tr.kernel_s
