"""The share of the traced window in which the card ran nothing."""
from perfbench.readers import idle_share as read  # noqa: F401
