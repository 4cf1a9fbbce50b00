"""The four assigned input-shape cells (LM-family shapes): the port's
copy of the JAX package's ``configs/shapes.py``."""
from repro_torch.core.types import ShapeSpec

SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4_096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32_768, global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524_288, global_batch=1),
}

# Smoke-scale variants of the same kinds (used by tests; tiny).
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=64, global_batch=2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=64, global_batch=2),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=64, global_batch=2),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=128, global_batch=1),
}
