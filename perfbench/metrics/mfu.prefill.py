"""deepseek-7b prefill: every batch completed in the window, at the
configuration's FLOPs (projections, causal attention, the head's last
row), as a share of the card's bf16 peak."""
from perfbench.readers import mfu as read  # noqa: F401
