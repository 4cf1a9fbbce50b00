"""granite prefill: the host ms of the Mamba2 layers' SSD scan
(``mamba.scan`` spans) a traced batch."""
from perfbench.harness import HERE, load_module


def read(ctx):
    return load_module(HERE / "metrics" / "granite_spans.py").span_ms(
        ctx, "mamba.scan")
