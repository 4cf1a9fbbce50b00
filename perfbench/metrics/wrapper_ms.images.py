"""Swin-T: the host time a ``vision.swin_forward`` call spends inside the
kernel wrappers (the ``kernel.*`` spans under it), the mean over the
traced batches; the rest of ``host_ms.images`` is the torch glue."""
from perfbench import program


def read(ctx):
    return program.wrapper_ms(ctx, "vision.swin_forward")
