"""Swin-T: the host time of one ``vision.swin_forward`` call, the mean
over the traced batches (the port's entry span)."""
from perfbench import program


def read(ctx):
    return program.host_ms(ctx, "vision.swin_forward")
