"""The trace reader on a hand-made trace."""
from perfbench import harness, trace

FAMS = trace.load_families(harness.HERE / "families")


def ev(name, start, end, device=False):
    return trace.Event(name, start, end, device)


def test_summary_of_a_hand_made_trace():
    events = [
        ev(trace.ROOT_SPAN, 0, 1000),
        ev("engine.decode", 100, 600),
        ev("aten::index", 410, 440),
        ev("bench.read", 700, 990),
        ev("rowwise_matmul_kernel_wgmma<1>", 150, 350, True),
        ev("attention_kernel_mma", 300, 400, True),     # overlaps: union
        ev("index_elementwise_kernel", 450, 500, True),
        ev("engine.decode", 120, 130, True),            # a device annotation
        ev("Memcpy DtoH", 950, 1100, True),             # clipped at 1000
    ]
    s = trace.summarize(events, FAMS)
    assert s.window_s == 1000 / 1e9
    assert s.busy_s == (250 + 50 + 50) / 1e9
    assert s.family_s["matmul"] == 200 / 1e9
    assert s.family_s["attention"] == 100 / 1e9
    assert s.family_s["glue"] == (50 + 50) / 1e9
    gaps = dict(s.gaps)
    assert gaps == {trace.ROOT_SPAN: 150 / 1e9,                 # 0..150
                    "aten::index in engine.decode": 50 / 1e9,   # 400..450
                    "bench.read": 450 / 1e9}                    # 500..950
    assert s.span_count["engine.decode"] == 1
    assert s.span_family_s["engine.decode"] == {
        "matmul": 200 / 1e9, "attention": 100 / 1e9, "glue": 50 / 1e9}
    assert s.span_family_s["bench.read"] == {"glue": 50 / 1e9}


def test_family_of():
    assert trace.family_of("void rowwise_matmul_kernel_skinny<...>",
                           FAMS) == "matmul"
    assert trace.family_of("layernorm_kernel_rows", FAMS) == "layernorm"
    assert trace.family_of("wkv_kernel_chunk", FAMS) == "wkv"
    assert trace.family_of("elementwise_kernel", FAMS) == "glue"
