"""program_idle_share.batch: the traced window's share, in %, in which no
operation ran on the device while the program's span
``drim.service.search`` was open on the host (``annbench.spans``); the
rest of ``idle_share.batch`` is the harness's loop between calls."""

from annbench import spans


def read(ctx):
    sp = spans.of(ctx)
    tr = ctx.trace
    if sp is None or not sp.found or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * sp.program_idle_s / tr.window_s
