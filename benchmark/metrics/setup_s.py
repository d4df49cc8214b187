"""Set-up: from the start of the process to the first timed epoch (the
agent's build, the kernel library's build on a first run, the warm-up
epoch at the cell's shapes; under data parallelism the ranks' start and
the process group's too)."""


def read(ctx):
    return ctx["ranks"][0]["setup_s"]
