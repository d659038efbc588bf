"""setup_s: seconds from process start to the first measured request
(imports, kernel load or build, drawing the index, ``AnnService.build``,
warm-up), on the host's clock."""


def read(ctx):
    return ctx.setup_s
