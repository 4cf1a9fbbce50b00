"""granite prefill: kernel launches a traced batch (the port's
``launch.<kernel>.<design>`` counters)."""
from perfbench import program


def read(ctx):
    return program.launches(ctx, "lm.prefill")
