"""Swin-T: the images completed in the window, at the configuration's
FLOPs an image (``work/swin_t.py``), as a share of the card's bf16 peak."""
from perfbench.readers import mfu as read  # noqa: F401
