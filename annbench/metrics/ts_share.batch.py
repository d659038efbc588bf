"""ts_share.batch: the share, in %, of the traced window's device-op
seconds (``trace.Trace.kernel_s``) launched inside the program's span
``drim.ts``: TS's top-k over every probed candidate and the gather of
the winners' ids (``annbench.spans``)."""

from annbench import spans


def read(ctx):
    return spans.device_share(ctx, "drim.ts")
