"""granite prefill: the host time of one ``lm.prefill`` call, the mean
over the traced batches (the port's entry span)."""
from perfbench import program


def read(ctx):
    return program.host_ms(ctx, "lm.prefill")
