"""dc_useful_share.batch: the share, in %, of the rows DC scanned in the
traced window that hold a point: the rows the window's probes hold, by
the harness's own count (``Context.scanned_rows``), over the program's
counter ``dc.rows_scanned`` (padding included) as counted while the
profiler recorded (``repro_torch.obs``)."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:           # a program without the counter
        return None
    scanned = obs.counts.traced.get("dc.rows_scanned", 0)
    if ctx.trace is None or scanned <= 0:
        return None
    return 100.0 * ctx.scanned_rows() / scanned
