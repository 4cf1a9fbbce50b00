"""The op-level cost walk (``launch/op_cost.py``), the whole-call
roofline (``launch/roofline.analyze``) and the kernel wrappers' ``meta``
branch.

* FLOPs: the walk of a call on the CPU equals ``hlo_cost.analyze_hlo``
  of JAX's compiled single-device call of the same reduced config,
  exactly: deepseek-7b's prefill (B=2 x 64), train step (remat) and
  decode step (a cache of 65), qwen2-moe-a2.7b's and rwkv6-3b's prefill
  and decode. One difference, named: rwkv6-3b's decode step counts
  2 x B x H x P more in the port, whose one-token WKV runs the chunked
  scan (the bonus term ``r . (u k)`` an einsum, a dot) where JAX's runs
  its step recurrence (the bonus element-wise).
* A launch's FLOPs (``plain_flops``) equal ``torch.utils.flop_counter``
  over its plain version; its bytes are its record's least bytes.
* Bytes are held to closed forms on a tiny hand-checked case, not to
  JAX's: XLA fuses the glue, the port runs it op by op.
* The meta branch: each wrapper checks a meta call as it checks a
  launch, notes the record its CPU call notes and returns an empty
  output of the CPU output's shape and dtype; no plain version runs and
  no launch is counted. A CUDA tensor (a fake one: this machine has no
  card) still reaches the launch path and raises.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_reduced as jget_reduced
from repro.launch import hlo_cost
from repro.launch import roofline as jroof
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import trace
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p
from repro_torch.launch import op_cost, roofline
from repro_torch.models import lm, rwkv6
from repro_torch.train import step as tsl

B, S = 2, 64


def _hlo_flops(fn, *args):
    return hlo_cost.analyze_hlo(
        jax.jit(fn).lower(*args).compile().as_text()).flops


def _pair(arch):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jparams, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jparams, from_jax_params(jparams, cfg, device="cpu")


def _serve_flops(arch):
    """(JAX's, the walk's) FLOPs of a prefill of B x S into a cache of
    S + 1 and of a decode step into it."""
    jcfg, cfg, jparams, params = _pair(arch)
    jtok = jnp.zeros((B, S), jnp.int32)
    tok = torch.zeros((B, S), dtype=torch.int32)
    jcache = jlm.init_cache(jcfg, B, S + 1, jnp.float32)
    want = (_hlo_flops(lambda p, t: jlm.prefill(p, t, jcfg), jparams, jtok),
            _hlo_flops(lambda p, c, t, n: jlm.decode_step(p, c, t, n, jcfg),
                       jparams, jcache, jtok[:, :1],
                       jnp.full((B,), S - 1, jnp.int32)))
    with torch.no_grad():
        (_, cache), pre = op_cost.walk(lm.prefill, params, tok, cfg,
                                       alloc=S + 1)
        _, dec = op_cost.walk(lm.decode_step, params, cache, tok[:, :1],
                              torch.full((B,), S - 1, dtype=torch.int32),
                              cfg)
    return cfg, want, (pre.flops, dec.flops)


def test_deepseek_flops_equal_jax_hlo():
    """Prefill, train step and decode step of the reduced deepseek-7b:
    the walk's FLOPs are JAX's HLO walk's, and the numbers the slice was
    opened with."""
    cfg, want, got = _serve_flops("deepseek-7b")
    assert got == want == (29_556_736, 527_360)
    jcfg, cfg, jparams, params = _pair("deepseek-7b")
    jt = jstep.TrainConfig(remat=True)
    jtok = jnp.zeros((B, S), jnp.int32)
    want_train = _hlo_flops(jstep.make_train_step(jcfg, jt),
                            jstep.init_state(jparams, jt),
                            {"tokens": jtok, "labels": jtok})
    tcfg = tsl.TrainConfig(remat=True)
    tok = torch.zeros((B, S), dtype=torch.int32)
    _, cost = op_cost.walk(tsl.make_train_step(cfg, tcfg),
                           tsl.init_state(params, tcfg),
                           {"tokens": tok, "labels": tok})
    assert cost.flops == want_train == 124_911_616
    # the backward's dots are glue (the plain versions differentiated),
    # the forward's and the recomputation's the kernels' records
    kernel_flops = sum(op_cost.plain_flops(r) for r in cost.records)
    assert cost.glue_flops > 0 and kernel_flops > 0
    assert cost.flops == cost.glue_flops + kernel_flops


def test_moe_flops_equal_jax_hlo():
    _, want, got = _serve_flops("qwen2-moe-a2.7b")
    assert got == want


def test_rwkv6_flops_equal_jax_hlo_but_the_decode_bonus():
    cfg, want, got = _serve_flops("rwkv6-3b")
    assert got[0] == want[0]
    # the port's one-token scan takes the bonus r . (u k) as a dot over
    # P for each of B x H rows in every layer; JAX's step does not
    h, p = cfg.d_model // cfg.head_dim, cfg.head_dim
    assert got[1] - want[1] == 2 * B * h * p * cfg.n_layers


@pytest.mark.parametrize("case", [
    "matmul", "gated", "int8", "attention_gqa_causal", "attention_bias",
    "attention_cross", "wkv", "wkv_ragged", "layernorm"])
def test_plain_flops_equal_the_flop_counter(case):
    """A launch's FLOPs from its record equal the flop counter over its
    plain version (the CPU call)."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g)
    calls = {
        "matmul": lambda: rowwise_matmul_p(rn(5, 24), rn(24, 7),
                                           bias=rn(7), activation="gelu"),
        "gated": lambda: rowwise_matmul_p(rn(6, 16), rn(16, 8),
                                          w_gate=rn(16, 8),
                                          activation="silu",
                                          prologue="rms", gamma=rn(16)),
        "int8": lambda: rowwise_matmul_p(
            torch.randint(-127, 128, (3, 32), dtype=torch.int8),
            torch.randint(-127, 128, (32, 5), dtype=torch.int8),
            x_scale=torch.rand(3, 1), w_scale=torch.rand(1, 5)),
        "attention_gqa_causal": lambda: flash_attention_p(
            rn(2, 4, 9, 16), rn(2, 2, 9, 16), rn(2, 2, 9, 16), causal=True),
        "attention_bias": lambda: flash_attention_p(
            rn(4, 2, 7, 16), rn(4, 2, 7, 16), rn(4, 2, 7, 16),
            causal=False, bias=rn(2, 2, 7, 7)),
        "attention_cross": lambda: flash_attention_p(
            rn(1, 2, 3, 32), rn(1, 2, 11, 32), rn(1, 2, 11, 32),
            causal=False),
        "wkv": lambda: wkv_p(rn(2, 32, 3, 16), rn(2, 32, 3, 16),
                             rn(2, 32, 3, 16), -torch.rand(2, 32, 3, 16),
                             rn(3, 16)),
        "wkv_ragged": lambda: wkv_p(rn(1, 21, 2, 16), rn(1, 21, 2, 16),
                                    rn(1, 21, 2, 16),
                                    -torch.rand(1, 21, 2, 16), rn(2, 16),
                                    s0=rn(1, 2, 16, 16)),
        "layernorm": lambda: layernorm_p(rn(6, 10), rn(10), rn(10)),
    }
    with roofline.recording() as recs, FlopCounterMode(display=False) as fc:
        calls[case]()
    assert len(recs) == 1
    assert op_cost.plain_flops(recs[0]) == fc.get_total_flops()


def test_walk_prices_a_kernel_once_by_its_record():
    """On the CPU the plain versions' ATen ops are the kernels': left out
    of the glue, each launch priced by its record's least bytes."""
    cfg = get_reduced("deepseek-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    tok = torch.zeros((B, 16), dtype=torch.int32)
    with torch.no_grad():
        _, cost = op_cost.walk(lm.prefill, params, tok, cfg)
    priced = roofline.price_all(cost.records)
    assert priced
    assert cost.bytes == sum(p.nbytes for p in priced) + cost.glue_bytes
    assert cost.flops == sum(op_cost.plain_flops(r) for r in cost.records)
    # every dot of a dense prefill runs in a kernel
    assert cost.glue_flops == 0 and "aten.mm" not in cost.by_op
    assert "aten.bmm" not in cost.by_op and "aten.rsqrt" not in cost.by_op
    attn = [r for r in cost.records if r["kernel"] == "flash_attention"]
    assert cost.attn_internal_bytes == sum(op_cost.score_bytes(r)
                                           for r in attn) > 0
    by_op, rows = op_cost.per_op_breakdown(cost)
    assert sum(b for b, _ in by_op.values()) == pytest.approx(cost.bytes)
    assert sum(f for _, f in by_op.values()) == cost.flops
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert sum(r[1] for r in rows if r[2].startswith("kernel ")) == \
        len(cost.records)


def test_walk_is_the_same_on_the_cpu_and_on_meta():
    """The same call on CPU and on meta tensors: the same FLOPs; on meta
    the norms take the card's route (layernorm_p then a prologue-free
    matmul where the prologue does not fit), as on the card."""
    cfg = get_reduced("deepseek-7b")
    out = {}
    for dev in ("cpu", "meta"):
        gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
        params = lm.init_lm(cfg, gen, device=dev, dtype=torch.bfloat16)
        tok = torch.zeros((4, 32), dtype=torch.int32, device=dev)
        with torch.no_grad():
            (_, cache), pre = op_cost.walk(lm.prefill, params, tok, cfg,
                                           alloc=33)
            _, dec = op_cost.walk(lm.decode_step, params, cache, tok[:, :1],
                                  torch.full((4,), 32, dtype=torch.int32,
                                             device=dev), cfg)
        out[dev] = (pre, dec)
    for a, b in zip(out["cpu"], out["meta"]):
        assert a.flops == b.flops
        assert all(not r["launched"] for r in b.records)
    kinds = {r["kernel"] for r in out["meta"][0].records}
    assert kinds == {"rowwise_matmul", "flash_attention", "layernorm"}


def test_bytes_of_a_tiny_case():
    """Each op's operand bytes plus its result bytes; views free; a
    broadcast operand at its real size; in place the written bytes once
    and the read ones once; a scatter the values twice."""
    x = torch.randn(4, 8)
    bias = torch.randn(8)
    w = torch.randn(8, 3)
    idx = torch.tensor([0, 2])
    vals = torch.randn(2, 8)

    def fn():
        y = x + bias                 # 128 + 32 read, 128 written
        yt = y.t()                   # a view: free
        z = torch.mm(x, w)           # 128 + 96 read, 48 written
        y.add_(1.0)                  # 128 read, 128 written
        s = yt.sum()                 # 128 read, 4 written
        y.index_put_((idx,), vals)   # 16 + 64 read, 64 written
        c = torch.empty(4, 8)        # free
        c.copy_(y)                   # 128 read, 128 written
        return z, s, c
    _, cost = op_cost.walk(fn)
    want = (128 + 32 + 128) + (128 + 96 + 48) + 2 * 128 + (128 + 4) \
        + (16 + 2 * 64) + 2 * 128
    assert cost.glue_bytes == cost.bytes == want
    assert cost.glue_flops == cost.flops == 2 * 4 * 8 * 3
    assert cost.by_op["aten.mm"][1] == 2 * 4 * 8 * 3
    assert "aten.t" not in cost.by_op and "aten.empty" not in cost.by_op
    assert cost.glue_ops == 6


def test_walk_tracks_the_peak_of_live_intermediates():
    x = torch.empty(1024, device="meta")        # an argument: not counted

    def fn():
        a = x * 2                 # 4 KiB live
        b = a * 2                 # 8 KiB
        del a                     # 4 KiB
        c = b * 2                 # 8 KiB
        del b
        return c
    _, cost = op_cost.walk(fn)
    assert cost.temp_bytes == 2 * 4096


def test_analyze_terms():
    """The whole call's report: JAX's keys, the unfused memory term the
    fused one plus the score traffic, the serial bound the kernels', the
    glue's and the collectives' one after another."""
    cfg = get_reduced("deepseek-7b")
    params = lm.init_lm(cfg, None, device="meta", dtype=torch.bfloat16)
    tok = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    with torch.no_grad():
        _, cost = op_cost.walk(lm.prefill, params, tok, cfg)
    cost.coll_bytes["all-gather"] += 450e6        # 1 ms on NVLink
    rep = roofline.analyze(cost, arch=cfg.name, shape="prefill", chips=4,
                           n_active=1000, tokens=256, kind="serve",
                           dtype=torch.bfloat16)
    d = rep.to_dict()
    jkeys = set(jroof.RooflineReport("a", "s", "m", 1, 0.0, 0.0, {},
                                     0.0).to_dict())
    assert jkeys - {"flash_min_bytes"} <= set(d)
    assert d["flops_per_device"] == cost.flops
    assert rep.memory_t - rep.memory_t_fused == pytest.approx(
        cost.attn_internal_bytes / roofline.PEAK_BYTES)
    priced = roofline.price_all(cost.records)
    assert rep.memory_t_fused == pytest.approx(
        (sum(p.nbytes for p in priced) + cost.glue_bytes)
        / roofline.PEAK_BYTES)
    assert rep.collective_t == pytest.approx(1e-3)
    assert rep.call_bound_ms == pytest.approx(
        sum(p.bound_ms for p in priced) + cost.glue_ms + 1.0)
    assert rep.step_time == max(rep.compute_t, rep.memory_t_fused,
                                rep.collective_t)
    assert rep.model_flops == 2 * 1000 * 256
    assert rep.useful_flops_ratio == pytest.approx(
        rep.model_flops / (4 * cost.flops))


def _cpu_and_meta(call, *tensors):
    """(CPU output, CPU record, meta output, meta record) of one call."""
    with roofline.recording() as cpu:
        out = call(*tensors)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t
            for t in tensors]
    with roofline.recording() as mrec:
        mout = call(*meta)
    return out, cpu, mout, mrec


def _wrapper_cases():
    g = torch.Generator().manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=g)
    i8 = torch.randint(-127, 128, (3, 32), dtype=torch.int8, generator=g)
    w8 = torch.randint(-127, 128, (32, 5), dtype=torch.int8, generator=g)
    return {
        "rowwise_matmul": (lambda x, w, b, r: rowwise_matmul_p(
            x, w, bias=b, residual=r, activation="gelu"),
            (rn(6, 16), rn(16, 8), rn(8), rn(6, 8))),
        "rowwise_matmul int8": (lambda x, w, xs, ws: rowwise_matmul_p(
            x, w, x_scale=xs, w_scale=ws), (i8, w8, torch.rand(3, 1),
                                            torch.rand(1, 5))),
        "flash_attention": (lambda q, k, v: flash_attention_p(
            q, k, v, causal=True, window=4), (rn(1, 4, 9, 16),
                                              rn(1, 2, 9, 16),
                                              rn(1, 2, 9, 16))),
        "layernorm": (lambda x, gm, bt: layernorm_p(x, gm, bt, kind="layer"),
                      (rn(5, 12), rn(12), rn(12))),
        "wkv": (lambda r, k, v, lw, u: wkv_p(r, k, v, lw, u),
                (rn(2, 20, 2, 16), rn(2, 20, 2, 16), rn(2, 20, 2, 16),
                 -torch.rand(2, 20, 2, 16, generator=g), rn(2, 16))),
    }


def _launches():
    return tuple(trace.launches(k) for k in (
        "rowwise_matmul", "flash_attention", "layernorm", "wkv"))


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_meta_branch_notes_the_cpu_record(name, monkeypatch):
    call, tensors = _wrapper_cases()[name]
    out, cpu, mout, mrec = _cpu_and_meta(call, *tensors)
    assert mrec == cpu and len(cpu) == 1 and not cpu[0]["launched"]
    outs = out if isinstance(out, tuple) else (out,)
    mouts = mout if isinstance(mout, tuple) else (mout,)
    for a, m in zip(outs, mouts):
        assert m.is_meta and m.shape == a.shape and m.dtype == a.dtype
    # no plain version runs for a meta tensor, and nothing is built: the
    # call is counted once, as the card's launch it stands for
    def plain(*args, **kw):
        raise AssertionError("a plain version ran for a meta tensor")
    for mod, fn in ((ref, "pipeline_ref"), (ref, "attention_ref"),
                    (rwkv6, "wkv_chunked")):
        monkeypatch.setattr(mod, fn, plain)
    monkeypatch.setattr("repro_torch.kernels.layernorm.rownorm", plain)
    with trace.recording():
        before = trace.launches(cpu[0]["kernel"])
        call(*[t.to("meta") for t in tensors])
        assert trace.launches(cpu[0]["kernel"]) == before + 1
    assert _build.library.cache_info().currsize == 0


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_a_cuda_tensor_still_takes_the_launch_path(name, monkeypatch,
                                                  trace_on):
    """A (fake) CUDA tensor goes to the launch path and raises on this
    machine, which has no card; it never takes the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    call, tensors = _wrapper_cases()[name]

    def plain(*args, **kw):
        raise AssertionError("a plain version ran for a CUDA tensor")
    for mod, fn in ((ref, "pipeline_ref"), (ref, "attention_ref"),
                    (rwkv6, "wkv_chunked")):
        monkeypatch.setattr(mod, fn, plain)
    monkeypatch.setattr("repro_torch.kernels.layernorm.rownorm", plain)
    before = _launches()
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
                for t in tensors]
        with pytest.raises((RuntimeError, AttributeError, ValueError)):
            call(*fake)
    assert _launches() == before


def test_meta_branch_checks_what_a_launch_checks():
    """The meta call runs the launch's checks: what no kernel takes
    raises on meta as it would on the card."""
    m = torch.empty(4, 8, device="meta")
    with pytest.raises(TypeError, match="no kernel"):
        rowwise_matmul_p(m.to(torch.float16),
                         torch.empty(8, 4, device="meta", dtype=torch.float16))
    q = torch.empty(1, 2, 4, 24, device="meta")
    with pytest.raises(NotImplementedError, match="head dim"):
        flash_attention_p(q, q, q)
    r = torch.empty(1, 5, 2, 16, device="meta")
    with pytest.raises(ValueError, match="u "):
        wkv_p(r, r, r, r, torch.ones(3, 16, device="meta"))
    with pytest.raises(ValueError, match="tensors on"):
        layernorm_p(m, torch.ones(8))


def test_costs_add_and_scale():
    """``add`` sums two walks (the peak of live bytes is the larger),
    ``scaled`` multiplies one (JAX's ``HLOCost`` API: a loop's body
    times its trips)."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    _, a = op_cost.walk(torch.mm, x, w)
    with torch.no_grad():
        _, b = op_cost.walk(rowwise_matmul_p, x, w)
    total = op_cost.OpCost()
    total.add(a)
    total.add(b)
    assert total.flops == a.flops + b.flops == 2 * 192
    assert total.bytes == a.bytes + b.bytes
    assert total.glue_ops == 1 and len(total.records) == 1
    assert total.by_op["aten.mm"][2] == 1
    three = total.scaled(3)
    assert three.flops == 3 * total.flops and three.bytes == 3 * total.bytes
    assert len(three.records) == 3 and three.by_op["aten.mm"][2] == 3
    assert three.temp_bytes == total.temp_bytes
