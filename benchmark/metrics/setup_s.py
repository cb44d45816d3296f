"""setup_s: start of the process to the first timed step (host clock)."""


def read(ctx):
    return ctx["setup_s"]
