"""The SSD scan kernel's wrapper (``kernels/ssd.py``, ``ops.ssd``) on the
CPU: its plain path, its meta branch (the card's checks, shapes and
counts without a launch) and its launch records' pricing. The kernel
itself runs on the card alone (``tests/test_torch_cuda.py``).

Tolerances: ``ops.ssd`` on CPU tensors and ``ssd_p``'s CPU branch run
the same torch ops as the mixer's chunked scan plus its skip, so they
are held to it exactly; against the per-step oracle ``ssd_ref`` (other
fp32 sums, every decay factor at most 1) rtol = atol = 2e-4, as
``tests/test_torch_mamba.py`` holds the scan to JAX's.
"""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import runtime, trace
from repro_torch.kernels import ops, ssd
from repro_torch.launch import op_cost, roofline
from repro_torch.models import mamba2

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, s, h, p, n, *, s0=False):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g)
    xh = rn(b, s, h, p)
    dt = torch.nn.functional.softplus(rn(b, s, h))
    a = -torch.exp(torch.rand(h, generator=g) * 2 - 1)
    B, C, D = rn(b, s, n), rn(b, s, n), rn(h)
    st = rn(b, h, p, n) if s0 else None
    return xh, dt, a, B, C, D, st


# S a multiple of the chunk, ragged, shorter than it, and S = 1 (a
# decode step): each without and with a starting state
SHAPES = [(2, 32, 3, 16, 16, 8), (2, 45, 3, 16, 16, 8),
          (1, 21, 2, 32, 16, 128), (2, 1, 4, 64, 64, 128),
          (1, 300, 2, 16, 64, 256)]


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ops_ssd_is_the_chunked_scan_plus_the_skip(b, s, h, p, n, chunk,
                                                   with_s0):
    """``ops.ssd`` and ``ssd_p`` on CPU tensors return the mixer's chunked
    scan plus ``D x`` bitwise, under either impl; both agree with the
    per-step oracle."""
    xh, dt, a, B, C, D, s0 = _inputs(s * 10 + n, b, s, h, p, n, s0=with_s0)
    y, st = mamba2.ssd_chunked(xh, dt, a, B, C, chunk=chunk, s0=s0)
    want = y + D[None, None, :, None] * xh
    for impl in ("auto", "ref"):
        with runtime.use_impl(impl):
            got_y, got_s = ops.ssd(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
        assert torch.equal(got_y, want) and torch.equal(got_s, st)
    got_y, got_s = ssd.ssd_p(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
    assert torch.equal(got_y, want) and torch.equal(got_s, st)
    ry, rs = mamba2.ssd_ref(xh, dt, a, B, C, s0=s0)
    torch.testing.assert_close(got_y, ry + D[None, None, :, None] * xh,
                               **TOL)
    torch.testing.assert_close(got_s, rs, **TOL)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (8, 407, 128, 64, 128, 256), (4, 1, 64, 64, 64, 128),
    (2, 45, 3, 16, 16, 8)])
def test_meta_call_checks_and_counts_two_launches(b, s, h, p, n, chunk,
                                                  with_s0, monkeypatch,
                                                  trace_on):
    """On meta tensors (granite's and zamba2's shapes, a reduced one):
    y (B, S, H, P) and the state (B, H, P, N) come back empty in fp32,
    the two launches are counted and recorded, and no plain version
    runs."""
    def plain(*args, **kw):
        raise AssertionError("the plain scan ran for a meta tensor")
    monkeypatch.setattr(mamba2, "ssd_chunked", plain)
    xh = torch.empty(b, s, h, p, device="meta")
    dt = torch.empty(b, s, h, device="meta")
    a, D = torch.empty(h, device="meta"), torch.empty(h, device="meta")
    B, C = (torch.empty(b, s, n, device="meta") for _ in range(2))
    s0 = torch.empty(b, h, p, n, device="meta") if with_s0 else None
    before = trace.launches("ssd")
    y, st = ops.ssd(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
    assert y.is_meta and tuple(y.shape) == (b, s, h, p)
    assert st.is_meta and tuple(st.shape) == (b, h, p, n)
    assert y.dtype == st.dtype == torch.float32
    assert trace.launches("ssd") == before + 2
    recs = [r for r in trace_on if r["kernel"] == "ssd"][-2:]
    assert [r["design"] for r in recs] == list(ssd.LAUNCHES)
    assert all(r["chunk"] == min(chunk, s) and not r["launched"]
               for r in recs)
    side = -(-min(chunk, s) // ssd.TILE) * ssd.TILE
    assert recs[0]["tensors"]["cb"][0] == (b, -(-s // min(chunk, s)),
                                           side, side)


@pytest.mark.parametrize("case", ["head_dim", "state_dim", "chunk",
                                  "dtype", "stride", "shape"])
def test_unsupported_calls_raise(case):
    """What the kernel does not take raises on meta as it would on the
    card: P outside (16, 32, 64), N outside (16, 64, 128), a chunk
    outside (8, 128, 256), a dtype but fp32, a last dim off unit stride,
    operands of mismatched shapes."""
    b, s, h, p, n, chunk = 2, 40, 3, 16, 16, 8
    dtype = torch.float32
    if case == "head_dim":
        p = 8
    elif case == "state_dim":
        n = 32
    elif case == "chunk":
        chunk = 64
    elif case == "dtype":
        dtype = torch.bfloat16

    def e(*shape):
        return torch.empty(*shape, device="meta", dtype=dtype)
    xh = e(b, s, h, p)
    if case == "stride":
        xh = e(b, s, p, h).transpose(2, 3)
    dt = e(b, s, h + (case == "shape"))
    with pytest.raises((TypeError, ValueError)):
        ssd.ssd_p(xh, dt, e(h), e(b, s, n), e(b, s, n), e(h), chunk=chunk)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 45, 3, 16, 16, 8),
                                             (1, 20, 2, 32, 64, 128),
                                             (2, 256, 2, 16, 16, 128)])
def test_records_price_the_scan(b, s, h, p, n, chunk):
    """The two records of a CPU call: their plain FLOPs sum to the flop
    counter over the plain version; their operations are the causal
    pairs' (``roofline.price``): C . B over N once a chunk, the intra
    term over the pairs and the inter and state terms (P x N a token)
    in every head."""
    xh, dt, a, B, C, D, s0 = _inputs(1, b, s, h, p, n, s0=True)
    with roofline.recording() as recs, FlopCounterMode(display=False) as fc:
        ssd.ssd_p(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
    assert [r["design"] for r in recs] == ["cb", "scan"]
    assert sum(op_cost.plain_flops(r) for r in recs) == fc.get_total_flops()
    ln = min(chunk, s)
    pairs = sum(c * (c + 1) // 2 for c in
                [ln] * (s // ln) + ([s % ln] if s % ln else []))
    assert roofline.price(recs[0])[0] == 2 * b * pairs * n
    assert roofline.price(recs[1])[0] == 2 * b * h * p * (pairs + 2 * s * n)
    nbytes = 4 * (b * s * (h * p + h + 2 * n) + 2 * h + b * h * p * n
                  + b * s * h * p + b * h * p * n)
    cb = 4 * math.prod(ssd.cb_shape(b, s, chunk))
    assert roofline.price(recs[1])[1] == nbytes + cb
    assert roofline.price(recs[0])[1] == 4 * 2 * b * s * n + cb
