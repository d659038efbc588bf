"""cl_share.batch: the share, in %, of the traced window's device-op
seconds (``trace.Trace.kernel_s``, ``topk_share.batch``'s base) launched
inside the program's span ``drim.cl``: CL's padded GEMM, its norms and
its top-nprobe (``annbench.spans``)."""

from annbench import spans


def read(ctx):
    return spans.device_share(ctx, "drim.cl")
