"""granite-4.0-h-small prefill: every traced batch at the configuration's
FLOPs (projections, the held experts at their expected rows, causal
attention, the SSD's recurrence, the head's last row), as a share of the
card's bf16 peak."""
from perfbench.readers import mfu as read  # noqa: F401
