"""gather_share.batch: the share, in %, of the traced window's device-op
seconds (``trace.Trace.kernel_s``) launched inside the program's span
``drim.gather``: the ``index_select`` of the probed clusters' padded
codes, ids and sizes (``annbench.spans``)."""

from annbench import spans


def read(ctx):
    return spans.device_share(ctx, "drim.gather")
