"""granite prefill: the host ms of the expert layers' spans (``moe.*``:
route, dispatch, experts, combine, shared) a traced batch."""
from perfbench.harness import HERE, load_module


def read(ctx):
    return load_module(HERE / "metrics" / "granite_spans.py").span_ms(
        ctx, "moe.")
