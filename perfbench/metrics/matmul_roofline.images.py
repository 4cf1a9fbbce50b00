"""The row-wise matmul family in the Swin-T cell: the least time of the
traced batches' projections over the family's device time."""
from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "matmul", ctx.work.matmul_least_s)
