"""The row-wise matmul family in the granite prefill cell: the least time
of the traced batches' projections (each held expert a call at its
expected rows) and head over the family's device time."""
from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "matmul", ctx.work.matmul_least_s)
