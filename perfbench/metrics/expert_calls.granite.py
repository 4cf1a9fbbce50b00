"""granite prefill: the row-wise matmul calls the held experts made a
traced batch (the port's ``moe.expert_calls`` counter): two an expert
that got rows, a layer."""
from perfbench.harness import HERE, load_module


def read(ctx):
    return load_module(HERE / "metrics" / "granite_spans.py").counter(
        ctx, "moe.expert_calls")
