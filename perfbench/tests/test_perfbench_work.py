"""The work formulas against hand counts."""
import pytest

from conftest import ROOT
from perfbench import harness

SWIN = harness.load_module(harness.HERE / "work" / "swin_t.py")
DENSE = harness.load_module(harness.HERE / "work" / "deepseek_7b.py")


def test_swin_hand_count():
    cfg = {"img_size": 16, "patch_size": 4, "in_chans": 3, "embed_dim": 8,
           "depths": [1, 1], "num_heads": [2, 4], "window_size": 2,
           "mlp_ratio": 4.0, "num_classes": 5}
    b = 2
    # patch embed: 2*16 tokens x 48 x 8; stage 1 (16 tokens an image, c 8)
    # qkv, proj, mlp; merge to 4 tokens, 32 -> 16; stage 2 (c 16); head
    mm = (2 * 32 * 48 * 8
          + 2 * 32 * (8 * 24 + 8 * 8 + 8 * 32 + 32 * 8)
          + 2 * 8 * 32 * 16
          + 2 * 8 * (16 * 48 + 16 * 16 + 16 * 64 + 64 * 16)
          + 2 * 2 * 16 * 5)
    # stage 1: 2 x 4 windows of 4 tokens, 2 heads of 4; stage 2: windows of
    # 2 x 2 tokens on a 2 x 2 grid, 4 heads of 4
    attn = 4 * 8 * 2 * 16 * 4 + 4 * 2 * 4 * 16 * 4
    unit = {"kind": "images", "batch": b}
    assert SWIN.matmul_flops(unit, cfg) == mm
    assert SWIN.attention_flops(unit, cfg) == attn
    assert SWIN.flops(unit, cfg) == mm + attn


def test_swin_t_published_count():
    cfg = harness.load_json(ROOT / "perfbench" / "configs" / "swin_t.json")
    # the paper's Table 1: 4.5 G multiply-adds an image at 224
    assert SWIN.flops({"kind": "images", "batch": 1}, cfg) == \
        pytest.approx(9.0e9, rel=0.01)


def test_dense_hand_count():
    cfg = {"hidden_size": 8, "intermediate_size": 12, "num_attention_heads": 2,
           "num_key_value_heads": 1, "vocab_size": 10,
           "num_hidden_layers": 3}
    b, s = 2, 5
    m = b * s
    proj = 2 * m * (8 * 16 + 8 * 8 + 8 * 24 + 12 * 8)   # qkv, o, gate|up, down
    attn = 4 * b * 2 * 4 * 15                            # 15 causal pairs
    head = 2 * b * 8 * 10
    assert DENSE.prefill_flops(cfg, b, s) == 3 * (proj + attn) + head
    step = 3 * (2 * (8 * 16 + 8 * 8 + 8 * 24 + 12 * 8) + 4 * 2 * 4 * 7) \
        + 2 * 8 * 10
    assert DENSE.decode_flops(cfg, 6) == step
    wave = {"kind": "wave", "prompt_lens": [5], "new_tokens": [3]}
    assert DENSE.flops(wave, cfg) == (DENSE.prefill_flops(cfg, 1, 5)
                                      + DENSE.decode_flops(cfg, 5)
                                      + DENSE.decode_flops(cfg, 6))


def test_least_time_is_the_larger_term():
    cfg = harness.load_json(ROOT / "perfbench" / "configs" / "deepseek_7b.json")
    unit = {"kind": "prefill", "batch": 4, "seq": 512}
    peak, bw = 989e12, 3.35e12
    t = DENSE.matmul_least_s(unit, cfg, peak, bw)
    ops = sum(2 * m * k * n for m, k, n in
              DENSE.layer_projections(cfg, 2048)) * 30
    assert t >= ops / peak
    assert DENSE.attention_least_s({"kind": "wave"}, cfg, peak, bw) == 0.0
