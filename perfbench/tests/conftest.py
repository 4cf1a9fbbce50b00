"""Shared set-up of the benchmark's tests: the checkout and ``src`` on the
path, the cells at a size the CPU runs in seconds, and the card fixture.

    python -m pytest -q perfbench/tests            # on the CPU
    python -m pytest -q -m cuda perfbench/tests    # on the card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

# every cell's configuration and traffic at a small size (widths, depth,
# vocabulary, lengths and batches cut; every key the code reads kept)
TINY_CONFIGS = {
    "swin_t": {"img_size": 56, "embed_dim": 32, "depths": [2, 2],
               "num_heads": [2, 4], "num_classes": 10},
    "deepseek_7b": {"vocab_size": 512, "hidden_size": 64,
                    "intermediate_size": 172, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "num_key_value_heads": 4},
}
TINY_TRAFFIC = {
    "batch64": {"batch": 4, "trace": {"skip_units": 2, "units": 3}},
    "prefill_mix": {"prompt_len": {"median": 12, "sigma": 0.5, "max": 16},
                    "cycle_batches": 3,
                    "trace": {"skip_units": 3, "units": 3}},
}


def manifest():
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_cell(name, **config):
    """The cell ``name`` with its configuration and traffic cut to
    ``TINY_*`` (and ``config`` over them)."""
    entry = next(w for w in manifest()["workloads"] if w["name"] == name)
    cfg = {**harness.load_json(
        harness.HERE / "configs" / f"{entry['config']}.json"),
        **TINY_CONFIGS[entry["config"]], **config}
    traffic = {**harness.load_json(
        harness.HERE / "traffic" / f"{entry['traffic']}.json"),
        **TINY_TRAFFIC[entry["traffic"]]}
    return harness.resolve(name, ROOT, config=cfg, traffic=traffic)


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)
