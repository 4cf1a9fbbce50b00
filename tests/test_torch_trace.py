"""The port's trace (``core/trace.py``): spans at the entry points, the
structure and the kernel wrappers, and the launch counters.

CPU tests, at the reduced Swin-T and deepseek-7b: with the trace off
nothing records; inside ``recording()`` and inside a CPU-activity
``torch.profiler`` session the spans nest entry > structure > kernel
under one unit id a call, and the launch counter counts what launched
or would launch (the meta path's calls). One test, marked ``cuda``,
holds the counters to a CUDA-activity profiler session on the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""
import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.swin_t import reduced
from repro_torch.core import trace
from repro_torch.kernels import rowwise_matmul as rm
from repro_torch.models import lm, vision

ENTRIES = {"swin": "vision.swin_forward", "prefill": "lm.prefill"}
# the spans an entry's structure spans may sit under
STRUCTURE = {"vision.stage": {"vision.swin_forward"},
             "vision.block": {"vision.stage"},
             "vision.merge": {"vision.stage"},
             "vision.head": {"vision.swin_forward"},
             "lm.embed": {"lm.prefill"}, "lm.layer": {"lm.prefill"},
             "lm.unembed": {"lm.prefill"},
             "lm.states_to_cache": {"lm.prefill"}}


def _meta(tree):
    return torch.utils._pytree.tree_map(
        lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, tree)


@pytest.fixture(scope="module")
def calls():
    """Each entry point's call at the reduced size, on CPU tensors or
    on ``meta``."""
    g = torch.Generator().manual_seed(0)
    scfg = reduced()
    sp = vision.init_swin(scfg, g, device="cpu")
    img = torch.randn(2, 56, 56, 3, generator=g)
    lcfg = get_reduced("deepseek-7b")
    lp = lm.init_lm(lcfg, g, device="cpu")
    toks = torch.randint(0, lcfg.vocab, (2, 9), generator=g)

    def swin(meta=False):
        f = _meta if meta else (lambda t: t)
        return vision.swin_forward(f(sp), f(img), scfg)

    def prefill(meta=False):
        f = _meta if meta else (lambda t: t)
        return lm.prefill(f(lp), f(toks), lcfg)
    return {"swin": swin, "prefill": prefill, "swin_cfg": scfg,
            "lm_cfg": lcfg}


@contextlib.contextmanager
def _tracing(how):
    """The trace on, inside ``recording()`` or a CPU profiler session."""
    if how == "recording":
        with trace.recording() as recs:
            yield recs
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            yield None


@pytest.fixture(autouse=True)
def _clean():
    trace.take()
    yield
    trace.take()


def test_off_records_nothing(calls):
    assert not trace.active()
    calls["swin"]()
    calls["swin"](meta=True)
    calls["prefill"]()
    calls["prefill"](meta=True)
    assert trace.take() == ([], {})
    assert trace.launches() == 0


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_spans_nest_under_their_entry(calls, how, entry):
    """Two calls: two units; every span under an entry carries its unit,
    lies inside its parent, and nests entry > structure > kernel."""
    with _tracing(how):
        calls[entry]()
        calls[entry]()
    spans, _ = trace.take()
    roots = [i for i, s in enumerate(spans) if s.name == ENTRIES[entry]]
    assert len(roots) == 2
    assert all(spans[i].parent == -1 for i in roots)
    units = [spans[i].unit for i in roots]
    assert units[0] is not None and units[1] == units[0] + 1
    names = collections.Counter(s.name for s in spans)
    assert names["kernel.rowwise_matmul"] > 0
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if i in roots:
            continue
        p = spans[s.parent]
        assert p.start <= s.start and s.end <= p.end, (s, p)
        assert s.unit == p.unit and s.unit in units
        if s.name.startswith("kernel."):
            assert not p.name.startswith("kernel.")
        else:
            assert p.name in STRUCTURE[s.name], (s.name, p.name)
    if entry == "swin":
        cfg = calls["swin_cfg"]
        assert names["vision.stage"] == 2 * len(cfg.depths)
        assert names["vision.block"] == 2 * sum(cfg.depths)
        assert names["vision.merge"] == 2 * (len(cfg.depths) - 1)
        assert names["vision.head"] == 2
        assert names["kernel.flash_attention"] == 2 * sum(cfg.depths)
    else:
        cfg = calls["lm_cfg"]
        assert names["lm.layer"] == 2 * cfg.n_layers
        for n in ("lm.embed", "lm.unembed", "lm.states_to_cache"):
            assert names[n] == 2


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_launch_counter_counts_what_would_launch(calls, how, entry):
    """On CPU tensors nothing launches and nothing counts; on ``meta``
    every kernel call stands for a launch: the counters equal the
    records by kernel and design, one a kernel span."""
    with trace.recording() as recs:
        calls[entry](meta=True)
    trace.take()
    want = collections.Counter(f"launch.{r['kernel']}.{r['design']}"
                               for r in recs)
    assert not any(r["launched"] for r in recs)
    with _tracing(how):
        calls[entry]()
    spans, counters = trace.take()
    assert counters == {} and spans
    with _tracing(how) as got:
        calls[entry](meta=True)
    spans, counters = trace.take()
    assert counters == dict(want)
    assert sum(counters.values()) == len(recs) == sum(
        s.name.startswith("kernel.") for s in spans)
    if got is not None:
        assert got == recs


def test_meta_swin_counts_seven_a_block(calls):
    """On meta the norms split from their matmuls as on the card: a
    block is 4 matmuls, 2 norms and the attention; then one matmul a
    merge, and the patch embedding, the final norm and the head."""
    cfg = calls["swin_cfg"]
    blocks, merges = sum(cfg.depths), len(cfg.depths) - 1
    with trace.recording():
        calls["swin"](meta=True)
    assert trace.launches() == 7 * blocks + merges + 3
    assert trace.launches("layernorm") == 2 * blocks + 1
    assert trace.launches("flash_attention") == blocks
    assert trace.MASKED not in trace.take()[1]


def test_masked_operand_predicate():
    """TMA takes an operand whose base and row stride are 16-byte
    aligned: an x 8 bytes off, or rows of 136 bytes, are masked; w
    counts in bf16 but not in int8 (transposed on the way in)."""
    bf = torch.bfloat16
    x, w = torch.zeros(4, 64, dtype=bf), torch.zeros(64, 32, dtype=bf)
    assert x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert not rm.tma_masked(x, w)
    off = torch.zeros(4 * 64 + 4, dtype=bf)[4:].view(4, 64)
    assert off.data_ptr() % 16 == 8
    assert rm.tma_masked(off, w)
    w_off = torch.zeros(64 * 32 + 4, dtype=bf)[4:].view(64, 32)
    assert rm.tma_masked(x, w_off) and rm.tma_masked(x, w, w_gate=w_off)
    wide = torch.zeros(4, 68, dtype=bf)[:, :64]
    assert rm.tma_masked(wide, w)
    x8 = torch.zeros(4 * 64 + 8, dtype=torch.int8)
    w8 = torch.zeros(64 * 32 + 8, dtype=torch.int8)
    assert rm.tma_masked(x8[8:].view(4, 64), w8[:2048].view(64, 32))
    assert not rm.tma_masked(x8[:256].view(4, 64), w8[8:].view(64, 32))


def test_spans_past_the_limit_are_counted(calls, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 5)
    with trace.recording():
        calls["swin"]()
    spans, counters = trace.take()
    assert len(spans) == 5
    assert counters[trace.DROPPED] > 0
    assert spans[0].name == "vision.swin_forward" and spans[0].end


def test_take_inside_a_span_raises():
    with trace.recording(), trace.span("outer"):
        with pytest.raises(RuntimeError):
            trace.take()
    spans, _ = trace.take()
    assert [s.name for s in spans] == ["outer"]


def test_meta_prefill_takes_the_persistent_design():
    """deepseek-7b's prefill of B=4 x 407 tokens (the benchmark mix's
    least) on meta tensors, routed as the card routes it: its 120
    projections on the persistent design and none on wgmma, 212
    launches in all."""
    cfg = get_config("deepseek-7b")
    params = lm.init_lm(cfg, None, device="meta", dtype=torch.bfloat16)
    tok = torch.zeros((4, 407), dtype=torch.int32, device="meta")
    with torch.no_grad(), trace.recording():
        trace.take()
        lm.prefill(params, tok, cfg)
        _, counters = trace.take()
    assert counters["launch.rowwise_matmul.persistent"] == 4 * cfg.n_layers
    assert "launch.rowwise_matmul.wgmma" not in counters
    assert trace.MASKED not in counters
    assert sum(n for k, n in counters.items()
               if k.startswith("launch.")) == 212


def test_meta_prefill_takes_the_ssd_kernel(monkeypatch, trace_on):
    """granite-4.0-h-small's prefill of B=8 x 407 tokens (the benchmark
    mix's least) on meta tensors: each of its 36 Mamba2 layers takes the
    SSD kernel's two launches (cb, scan), 72 in all. Its dropless expert
    layer reads its counts to the host, which a meta tensor cannot: a
    stand-in of the layer's shape takes its place."""
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "_apply_dropless",
                        lambda params, x, cfg: (torch.zeros_like(x), 0.0))
    cfg = get_config("granite-4.0-h-small")
    params = lm.init_lm(cfg, None, device="meta", dtype=torch.bfloat16)
    tok = torch.zeros((8, 407), dtype=torch.int32, device="meta")
    with torch.no_grad():
        trace.take()
        lm.prefill(params, tok, cfg)
        _, counters = trace.take()
    mamba = cfg.layer_pattern.count("M") * cfg.n_layers // len(
        cfg.layer_pattern)
    assert mamba == 36
    assert counters["launch.ssd.cb"] == counters["launch.ssd.scan"] == mamba
    assert sum(n for k, n in counters.items()
               if k.startswith("launch.ssd.")) == 2 * mamba


@pytest.mark.cuda
def test_cuda_profiler_session_counts_launches():
    """On the card, under a CUDA-activity profiler session alone (as the
    benchmark's traced run opens): each bf16 launch counts under its
    design (the persistent one; the wgmma one for x 8 bytes off its
    alignment, which counts as masked too), and each call is a kernel
    span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    x = torch.randn(256, 512, device=dev, dtype=bf)
    w = torch.randn(512, 256, device=dev, dtype=bf)
    off = torch.randn(256 * 512 + 4, device=dev, dtype=bf)[4:].view(256, 512)
    rm.rowwise_matmul_p(x, w)
    torch.cuda.synchronize()
    trace.take()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert trace.active()
        a = rm.rowwise_matmul_p(x, w)
        b = rm.rowwise_matmul_p(off, w)
        torch.cuda.synchronize()
    spans, counters = trace.take()
    assert counters == {"launch.rowwise_matmul.persistent": 1,
                        "launch.rowwise_matmul.wgmma": 1, trace.MASKED: 1}
    assert [s.name for s in spans] == ["kernel.rowwise_matmul"] * 2
    want = (off.float() @ w.float())
    assert (b.float() - want).abs().max() <= 0.05 * want.abs().max()
    assert a.shape == (256, 256)
