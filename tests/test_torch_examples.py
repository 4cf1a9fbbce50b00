"""The port's examples (``examples/torch_*.py``) on the CPU at their
smoke sizes: each ``main`` runs with ``--device cpu`` and prints what
the JAX package's example prints; without a card and without
``--device cpu`` each raises rather than run on the CPU."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "row-wise plan: design=ffma" in out and "smem=" in out
    assert "matmul+gelu: (3136, 288) torch.float32" in out
    err = float(out.split("int8 W8A8 relative error: ")[1].split()[0])
    assert 0 < err < 0.02
    assert out.count("step ") == 3 and "loss=" in out


def test_vit_rowwise(capsys):
    _example("vit_rowwise").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "peak throughput : 403.2 GOPS" in out
    assert "swin-t images/s : 43.9" in out
    assert "=== H100 row-wise schedule (same GEMM walk) ===" in out
    assert "swin-smoke fwd on cpu: (8, 10)" in out


def test_serve_lm(capsys):
    _example("serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "statuses: {'ok': 10}" in out
    assert "placement=single-device device=cpu" in out


def test_train_lm_resumes(tmp_path, capsys):
    ex = _example("train_lm")
    ex.main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
             str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 2:" in out and "done" in out
    assert any(tmp_path.iterdir())
    # a second run resumes from the checkpoint: no step left to take
    ex.main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
             str(tmp_path)])
    assert "step 0:" not in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "vit_rowwise", "serve_lm",
                                  "train_lm"])
def test_examples_refuse_to_fall_back_to_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(argv)


def test_train_driver_takes_the_example_config(capsys):
    """The train example's 100m preset hands its config to the driver
    (``train.main(argv, cfg=)``), registering nothing: the driver trains
    the config it is given, and ``configs.ARCHS`` stays as it was."""
    from repro_torch import configs
    from repro_torch.core.types import ModelConfig
    from repro_torch.launch import train
    cfg = ModelConfig(name="llama-tiny", family="dense", n_layers=2,
                      d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab=128, act="silu", norm="rms")
    before = dict(configs.ARCHS)
    train.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                "16"], cfg=cfg)
    out = capsys.readouterr().out
    assert "arch=llama-tiny layers=2 d=32" in out and "step 1:" in out
    assert configs.ARCHS == before and "llama-tiny" not in configs.ARCHS
    with pytest.raises(ValueError, match="one device"):
        train.main(["--mesh", "host", "--device", "cpu"], cfg=cfg)
