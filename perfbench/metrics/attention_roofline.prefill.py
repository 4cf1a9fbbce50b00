"""The flash attention family in the deepseek-7b prefill cell: causal
attention's least time at each traced batch's length over the family's
device time."""
from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "attention", ctx.work.attention_least_s)
