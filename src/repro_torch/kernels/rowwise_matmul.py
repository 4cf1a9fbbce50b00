"""Row-wise matmul — the paper's dot-product primitive as one kernel.

``rowwise_matmul_p`` runs the whole fused pipeline of a transformer
sublayer in one launch: optional LayerNorm/RMSNorm prologue on the
activation rows (fp32 statistics over the true K, the normed value cast
back to the streaming dtype before the dot), ``x @ w`` accumulated in
fp32 (int32 in the int8 W8A8 mode), then the post-processing epilogue —
int8 dequant, bias, activation or the gated ``act(x@wg + bg) *
(x@w + b)``, residual add, cast to ``out_dtype``.

Four designs behind one C entry point (``csrc/rowwise_matmul*.cu``),
picked by :func:`pick_design` from M and the dtype and, in bf16, the
shape and the operands (:func:`call_design`):

* ``skinny`` (M <= 16 fp32, M <= 4 bf16 and int8:
  :data:`SKINNY_PICK_M`): bytes-bound, split-K over about one wave of
  blocks, the splits summed in a fixed order by the last block of each
  column tile;
* ``persistent`` (bf16 from :data:`PERSISTENT_MIN_M` rows, no norm
  prologue, operands TMA takes): clusters of two blocks, one an SM,
  walking 128 x 256 tiles in groups of row panels, the weights' tile
  multicast to both, the epilogue beside the next tile's loads;
* ``wgmma`` (the other bf16 calls above the skinny rows, and int8):
  Hopper tensor cores fed by a TMA / mbarrier ring, one tile a block;
* ``ffma`` (fp32, M > 16): exact fp32 FFMA on a register-blocked tile.

For a CPU tensor it runs the plain :func:`ref.pipeline_ref`; for a
``meta`` tensor it checks the call as for a launch and returns the empty
output (``_build.check_cuda``). Each call is the span
``kernel.rowwise_matmul`` of the port's trace (``core/trace.py``),
noted there with its design. Operands
are taken with their row strides (unit column stride), so the halves of
a pre-fused weight panel need no copy; biases and norm gains are read in
the dtype they are stored in (fp32 or bf16).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import trace
from repro_torch.core.rowwise import H100
from repro_torch.kernels import _build, ref
from repro_torch.kernels.layernorm import KINDS

ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2, "relu": 3, "relu2": 4}
# pick_design sends the skinny design (which takes up to 16 rows) the
# calls of up to SKINNY_PICK_M rows of each dtype, where it beats the
# other design: on the H100 at 2560 x 2560 with the weights cold, bf16
# 13.0 µs at M=4 against wgmma's 24.5, but 36.0 against 24.7 at M=8;
# fp32 29.5 µs at M=16 against ffma's 130.8 (chip_smoke.py's threshold
# line; PERF.md).
SKINNY_PICK_M = {torch.float32: 16, torch.bfloat16: 4, torch.int8: 4}
# the largest K at which the skinny design keeps a norm prologue in the
# kernel (:func:`norm_prologue_fits`); past it, and on the other designs
# at every K, ``ops`` runs ``layernorm_p`` and then the matmul without
# one, as the JAX package's ``_plan_norm_fallback`` does past one VMEM
# panel. On an NVIDIA H100 80GB HBM3 at 700 W the wgmma and ffma
# prologues lost to that split at every K measured, 64 .. 8192, on the
# LM panels (deepseek-7b's, gemma3-27b's) and Swin-T's and ViT-B/16's
# (wgmma 1.2-10.3x the split's device time, ffma 1.15-1.47x); the
# skinny design's held to K = 1024 in both dtypes (0.81-1.09x)
# (chip_smoke.py's prologue threshold line; PERF.md). Device time sets
# the skinny boundary: decode tokens/s end to end with it at 1024 and at
# 8192 (deepseek-7b, gemma3-27b; the decode A/B lines) differed by less
# than the host-bound steps' spread from run to run
SKINNY_NORM_MAX_K = 1024
# pick_design sends the persistent design the bf16 calls of at least
# PERSISTENT_MIN_M rows (with no norm prologue and operands TMA takes), at
# every N and K: on an NVIDIA H100 80GB HBM3 at 700 W it beat the wgmma
# design at every projection of the benchmark's cells, deepseek-7b's
# prefill at M = 1628 .. 16384 (1.72-2.29x) and Swin-T's B=64 forward at
# K = 48 .. 3072, N = 96 .. 3072, M = 64 .. 200704 (1.81-4.35x); at
# deepseek-7b's projections of 8, 16 and 32 rows the two split
# (0.89-1.33x), so fewer than 64 rows keep wgmma (chip_smoke.py's
# persistent lines; PERF.md)
PERSISTENT_MIN_M = 64
DESIGNS = {"ffma": 0, "skinny": 1, "wgmma": 2, "persistent": 3}
# the skinny design's columns per block, the blocks it aims for per SM
# (one wave at two blocks per SM), and the fewest K rows of a split
_SKINNY_COLS = 64
_SKINNY_BLOCKS_PER_SM = 2
_SKINNY_MIN_ROWS = 256
_VEC_BITS = {"bias": 1, "bias_gate": 2, "gamma": 4, "pbeta": 8}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P,          # x w wg b bg res g be
             _P, _P, _P, _P, _P, _P,                  # xs ws wgs out work cnt
             _LL, _LL, _LL, _LL, _LL,                 # ld x w wg res out
             _I, _I, _I, _I, _I,                      # m n k norm act
             _I, _I, _I, _I, _I, _I,                  # dt res out vec splits kc
             ctypes.c_float, _I, _P)                  # eps design stream
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_counters: dict = {}
_work: dict = {}
_sms: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def persistent_fits(m: int, n: int, k: int) -> bool:
    """Whether the route sends a bf16 call of M rows of (K, N) to the
    persistent design (when it has no norm prologue and TMA takes its
    operands): M of at least PERSISTENT_MIN_M, any N and K."""
    return m >= PERSISTENT_MIN_M


def pick_design(m: int, dtype: torch.dtype, n: int, k: int, *,
                masked: bool = False, prologue: bool = False) -> str:
    """The design a call of M rows of (K, N) in ``dtype`` takes;
    ``masked``: an operand TMA cannot take (:func:`tma_masked`);
    ``prologue``: a norm in the kernel's prologue."""
    if m <= SKINNY_PICK_M[dtype]:
        return "skinny"
    if dtype == torch.float32:
        return "ffma"
    if (dtype == torch.bfloat16 and not masked and not prologue
            and persistent_fits(m, n, k)):
        return "persistent"
    return "wgmma"


def norm_prologue_fits(m: int, k: int, dtype: torch.dtype) -> bool:
    """Whether a call of M rows of K in ``dtype`` keeps its norm in the
    kernel's prologue: the skinny design, up to :data:`SKINNY_NORM_MAX_K`."""
    return m <= SKINNY_PICK_M[dtype] and k <= SKINNY_NORM_MAX_K


def tma_masked(x: torch.Tensor, w: torch.Tensor,
               w_gate: Optional[torch.Tensor] = None) -> bool:
    """Whether an operand of this call is one TMA cannot take, which the
    wgmma design then loads by masked copies: TMA takes an operand whose
    base and row stride are 16-byte aligned (``encode`` in
    ``csrc/tma.cuh``), x in every dtype, w and w_gate in bf16 (an int8 w
    is transposed on the way in, never by TMA). A ``meta`` tensor's base
    is its offset into an aligned storage."""
    def base(t):
        return (t.storage_offset() * t.element_size() if t.is_meta
                else t.data_ptr())
    operands = (x,) if x.dtype == torch.int8 else (x, w, w_gate)
    return any(t is not None and (base(t) % 16 or
                                  t.stride(0) * t.element_size() % 16)
               for t in operands)


def call_design(x: torch.Tensor, w: torch.Tensor,
                w_gate: Optional[torch.Tensor] = None,
                prologue: Optional[str] = None) -> str:
    """The design :func:`rowwise_matmul_p` takes for these operands."""
    m, k = x.shape
    masked = x.dtype == torch.bfloat16 and tma_masked(x, w, w_gate)
    return pick_design(m, x.dtype, w.shape[1], k, masked=masked,
                       prologue=prologue is not None)


def _rows(name, t, shape):
    if t is None:
        return
    if tuple(t.shape) != shape or (t.numel() and t.stride(-1) != 1):
        raise ValueError(f"rowwise_matmul_p: {name} {tuple(t.shape)} "
                         f"strides {t.stride()}, want {shape} with unit "
                         "column stride")


def _check_int8(x, w, w_gate, x_scale, w_scale, wg_scale, prologue):
    m, n = x.shape[0], w.shape[1]
    for name, t in (("x", x), ("w", w), ("w_gate", w_gate)):
        if t is not None and t.dtype != torch.int8:
            raise TypeError(f"rowwise_matmul_p: int8 mode (scales given) "
                            f"needs int8 {name}, got {t.dtype}")
    for name, t, shape in (("x_scale", x_scale, (m, 1)),
                           ("w_scale", w_scale, (1, n)),
                           ("wg_scale", wg_scale, (1, n))):
        if t is None:
            if name != "wg_scale" or w_gate is not None:
                raise TypeError(f"rowwise_matmul_p: int8 mode needs "
                                f"{name}")
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"rowwise_matmul_p: {name} is {t.dtype} "
                            f"{tuple(t.shape)}, want float32 {shape}")
    if prologue is not None:
        raise ValueError("rowwise_matmul_p: the norm prologue runs on "
                         "float activations, not in the int8 mode")


def _vector(name, t, size):
    """A bias or norm gain as the kernel reads it, and its VecF32 bit."""
    if t is None:
        return None, 0
    if tuple(t.shape) != (size,):
        raise ValueError(f"rowwise_matmul_p: {name} {tuple(t.shape)}, "
                         f"want ({size},)")
    t = _build.vector(t)
    return t, (_VEC_BITS[name] if t.dtype == torch.float32 else 0)


def skinny_splits(n: int, k: int, gated: bool, sms: int) -> tuple:
    """(splits, kc) of the skinny design: about one wave of blocks (two
    per SM of ``sms``), each split at least _SKINNY_MIN_ROWS rows, kc a
    multiple of the 64 rows a block has in flight."""
    tiles = _cdiv(n, _SKINNY_COLS)
    z = 2 if gated else 1
    want = _cdiv(_SKINNY_BLOCKS_PER_SM * sms, tiles * z)
    splits = max(1, min(want, _cdiv(k, _SKINNY_MIN_ROWS)))
    kc = _cdiv(_cdiv(k, splits), 64) * 64
    return _cdiv(k, kc), kc


def _skinny_plan(dev, m, n, k, gated):
    """K splits for the skinny design (:func:`skinny_splits`); the
    workspace for their partial sums (4-byte fp32 or int32) and the
    column tiles' counters (zeroed once: the kernel leaves them zeroed).
    Both are kept per device and grown as needed, as calls on one stream
    run in order."""
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = _cdiv(n, _SKINNY_COLS)
    z = 2 if gated else 1
    splits, kc = skinny_splits(n, k, gated, _sms[dev])
    counters = _counters.get(dev)
    if counters is None or counters.numel() < tiles:
        counters = _counters[dev] = torch.zeros(max(tiles, 4096),
                                                dtype=torch.int32,
                                                device=dev)
    work = _work.get(dev)
    if work is None or work.numel() < z * splits * m * n:
        work = _work[dev] = torch.empty(max(z * splits * m * n, 1 << 20),
                                        dtype=torch.int32, device=dev)
    return splits, kc, work, counters


def _note(design, t, prologue, splits=None, masked=False):
    """The record and counts (``trace.note``) of a call on the operands
    ``t`` (:func:`rowwise_matmul_p`'s tensors by name): off the card (a
    CPU or meta tensor) the K splits of an H100."""
    if splits is None:
        n, k = t["w"].shape[1], t["x"].shape[1]
        splits = (skinny_splits(n, k, t.get("w_gate") is not None,
                                H100.sms)[0]
                  if design == "skinny" and n and k else 0)
    trace.note("rowwise_matmul", design, t, t["out"].device, masked=masked,
               prologue=prologue, splits=splits)


def _launch(dev, design, t, vecs, vec_bits, *, prologue=None,
            activation=None, out_dtype, eps=1e-6):
    """Launch ``design`` on the checked operands ``t`` (by name, as
    :func:`_note` takes them; ``out`` allocated, M and N not 0), the
    vectors as :func:`_vector` gives them in ``vecs``, and note it."""
    x, w, out = t["x"], t["w"], t["out"]
    w_gate, residual = t.get("w_gate"), t.get("residual")
    m, k = x.shape
    n = w.shape[1]
    splits = kc = 0
    work = counters = None
    if design == "skinny":
        splits, kc, work, counters = _skinny_plan(dev, m, n, k,
                                                  w_gate is not None)
    err = _build.function("rk_rowwise_matmul", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), _build.ptr(w_gate),
        _build.ptr(vecs.get("bias")), _build.ptr(vecs.get("bias_gate")),
        _build.ptr(residual), _build.ptr(vecs.get("gamma")),
        _build.ptr(vecs.get("pbeta")), _build.ptr(t.get("x_scale")),
        _build.ptr(t.get("w_scale")), _build.ptr(t.get("wg_scale")),
        out.data_ptr(), _build.ptr(work), _build.ptr(counters),
        x.stride(0), w.stride(0),
        w_gate.stride(0) if w_gate is not None else 0,
        residual.stride(0) if residual is not None else 0, out.stride(0),
        m, n, k, KINDS.get(prologue, 0), ACTIVATIONS[activation],
        _DT[x.dtype], _DT[residual.dtype] if residual is not None else 0,
        _DT[out_dtype], vec_bits, splits, kc, eps, DESIGNS[design],
        _build.stream(dev))
    _build.check(err, "rowwise_matmul_p")
    if trace.active():
        _note(design, t, prologue, splits,
              design == "wgmma" and tma_masked(x, w, w_gate))


@trace.traced("kernel.rowwise_matmul")
def rowwise_matmul_p(x: torch.Tensor, w: torch.Tensor, *,
                     bias: Optional[torch.Tensor] = None,
                     x_scale: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     w_gate: Optional[torch.Tensor] = None,
                     bias_gate: Optional[torch.Tensor] = None,
                     wg_scale: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None,
                     prologue: Optional[str] = None,
                     gamma: Optional[torch.Tensor] = None,
                     pbeta: Optional[torch.Tensor] = None,
                     eps: float = 1e-6,
                     out_dtype=None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K); w: (K, N); bias: (N,) -> (M, N).

    int8 W8A8 mode when scales are given: x and w int8, x_scale (M, 1)
    and w_scale (1, N) fp32 (wg_scale (1, N) too when gated); int32
    accumulation, dequant in the epilogue, fp32 output by default.
    w_gate: (K, N) second weight — gated mode, out = act(x@wg) * (x@w).
    residual: (M, N) added after activation/gating, before the cast.
    prologue: 'layer' | 'rms' — normalize the x rows in-kernel
    (gamma/pbeta: (K,)); float mode only.
    out: (M, N) rows of unit column stride in ``out_dtype``, written in
    place and returned (a new tensor when None).
    The design is :func:`call_design`'s.
    """
    int8 = any(s is not None for s in (x_scale, w_scale, wg_scale))
    if int8:
        _check_int8(x, w, w_gate, x_scale, w_scale, wg_scale, prologue)
    elif x.dtype == torch.int8:
        raise TypeError("rowwise_matmul_p: int8 x needs x_scale and "
                        "w_scale")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if prologue is not None and (prologue not in KINDS or gamma is None):
        raise ValueError(f"prologue {prologue!r} needs 'layer' or 'rms' "
                         "and gamma")
    out_dtype = out_dtype or (torch.float32 if int8 else x.dtype)

    def operands():
        return dict(x=x, w=w, w_gate=w_gate, bias=bias, bias_gate=bias_gate,
                    residual=residual, gamma=gamma, pbeta=pbeta,
                    x_scale=x_scale, w_scale=w_scale, wg_scale=wg_scale,
                    out=out)

    if out is not None:
        if out.dtype != out_dtype or out.device != x.device:
            raise TypeError(f"rowwise_matmul_p: out is {out.dtype} on "
                            f"{out.device}, want {out_dtype} on {x.device}")
        _rows("out", out, (x.shape[0], w.shape[1]))
    if x.device.type == "cpu":
        with trace.plain_call():
            res = ref.pipeline_ref(
                x, w, bias=bias, activation=activation, w_gate=w_gate,
                bias_gate=bias_gate, residual=residual, norm_kind=prologue,
                gamma=gamma, beta=pbeta, eps=eps, out_dtype=out_dtype,
                x_scale=x_scale, w_scale=w_scale, wg_scale=wg_scale)
            out = res if out is None else out.copy_(res)
        if trace.records is not None and x.dtype in _DT:
            _note(call_design(x, w, w_gate, prologue), operands(), prologue)
        return out

    dev = _build.check_cuda("rowwise_matmul_p", x, w, w_gate, bias,
                            bias_gate, residual, gamma, pbeta, x_scale,
                            w_scale, wg_scale)
    m, k = x.shape
    n = w.shape[1]
    _rows("x", x, (m, k))
    _rows("w", w, (k, n))
    _rows("w_gate", w_gate, (k, n))
    _rows("residual", residual, (m, n))
    if x.dtype not in _DT:
        raise TypeError(f"rowwise_matmul_p: no kernel for {x.dtype}")
    for name, t in (("w", w), ("w_gate", w_gate)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"rowwise_matmul_p: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
    floats = ((torch.float32, torch.bfloat16) if int8
              else (x.dtype, torch.float32))
    if residual is not None and residual.dtype not in floats:
        raise TypeError(f"rowwise_matmul_p: residual is {residual.dtype}")
    if out_dtype not in floats:
        raise TypeError(f"rowwise_matmul_p: out_dtype {out_dtype}")
    design = call_design(x, w, w_gate, prologue)
    if k == 0:
        raise ValueError("rowwise_matmul_p: K = 0")

    # the kernel reads a scale per row and per column, unit stride
    x_scale, w_scale, wg_scale = (None if t is None else t.contiguous()
                                  for t in (x_scale, w_scale, wg_scale))
    vec_bits, vecs = 0, {}
    for name, t, size in (("bias", bias, n), ("bias_gate", bias_gate, n),
                          ("gamma", gamma, k), ("pbeta", pbeta, k)):
        vecs[name], bit = _vector(name, t, size)
        vec_bits |= bit
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if not (m and n):
        return out
    if dev.type == "meta":
        # shapes alone (the dry run's): checked as for a launch, no launch
        if trace.active():
            _note(design, operands(), prologue)
        return out
    _launch(dev, design, operands(), vecs, vec_bits, prologue=prologue,
            activation=activation, out_dtype=out_dtype, eps=eps)
    return out


@trace.traced("kernel.rowwise_matmul_groups")
def rowwise_matmul_groups_p(x: torch.Tensor, w: torch.Tensor, sizes, *,
                            gated: bool = False,
                            activation: Optional[str] = None,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Consecutive row groups of x (R, K), each times its own weight:
    group g, its ``sizes[g]`` rows, @ ``w[g]`` (w: (G, K, N)); with
    ``gated`` each ``w[g]`` is a [gate | up] panel (K, 2F) and the rows
    get ``act(x wg) * (x wi)``. -> ``out`` (R, N or F), each group's
    rows written in place: one launch a non-empty group, as
    :func:`rowwise_matmul_p` makes it (its design, its record), with the
    operands checked once for all of them, which is what the dropless
    expert layer's host time is made of. A CPU or meta tensor takes
    :func:`rowwise_matmul_p` a group at a time."""
    f = w.shape[-1] // 2 if gated else w.shape[-1]
    r, k = x.shape
    if out is None:
        out = x.new_empty((r, f))
    if w.dim() != 3 or w.shape[:2] != (len(sizes), k) or sum(sizes) != r:
        raise ValueError(f"rowwise_matmul_groups_p: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, {len(sizes)} groups of "
                         f"{sum(sizes)} rows")

    def groups():
        start = 0
        for g, m in enumerate(sizes):
            if m:
                wg = w[g]
                yield dict(x=x[start:start + m],
                           w=wg[:, f:] if gated else wg,
                           w_gate=wg[:, :f] if gated else None,
                           out=out[start:start + m])
            start += m

    if x.device.type != "cuda":
        for t in groups():
            rowwise_matmul_p(**t, activation=activation)
        return out
    dev = _build.check_cuda("rowwise_matmul_groups_p", x, w, out)
    _rows("x", x, (r, k))
    _rows("out", out, (r, f))
    if w.stride(-1) != 1 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("rowwise_matmul_groups_p: w of unit column stride "
                         "and a float x, please")
    if w.dtype != x.dtype or out.dtype != x.dtype:
        raise TypeError(f"rowwise_matmul_groups_p: x {x.dtype}, w "
                        f"{w.dtype}, out {out.dtype}")
    for t in groups():
        _launch(dev, call_design(t["x"], t["w"], t["w_gate"]), t, {}, 0,
                activation=activation, out_dtype=x.dtype)
    return out
