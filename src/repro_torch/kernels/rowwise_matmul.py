"""Row-wise matmul — the paper's dot-product primitive as one kernel.

``rowwise_matmul_p`` runs the whole fused pipeline of a transformer
sublayer in one launch: optional LayerNorm/RMSNorm prologue on the
activation rows (fp32 statistics over the true K, the normed value cast
back to the streaming dtype before the dot), ``x @ w`` accumulated in
fp32 (int32 in the int8 W8A8 mode), then the post-processing epilogue —
int8 dequant, bias, activation or the gated ``act(x@wg + bg) *
(x@w + b)``, residual add, cast to ``out_dtype``.

Three designs behind one C entry point (``csrc/rowwise_matmul*.cu``),
picked by :func:`pick_design` from M and the dtype:

* ``skinny`` (M <= 16 fp32, M <= 4 bf16 and int8:
  :data:`SKINNY_PICK_M`): bytes-bound, split-K over about one wave of
  blocks, the splits summed in a fixed order by the last block of each
  column tile;
* ``wgmma`` (bf16 and int8 above that): Hopper tensor cores fed by a
  TMA / mbarrier ring;
* ``ffma`` (fp32, M > 16): exact fp32 FFMA on a register-blocked tile.

For a CPU tensor it runs the plain :func:`ref.pipeline_ref`; for a
``meta`` tensor it checks the call as for a launch and returns the empty
output (``_build.check_cuda``). Operands
are taken with their row strides (unit column stride), so the halves of
a pre-fused weight panel need no copy; biases and norm gains are read in
the dtype they are stored in (fp32 or bf16).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

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
DESIGNS = {"ffma": 0, "skinny": 1, "wgmma": 2}
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


def pick_design(m: int, dtype: torch.dtype) -> str:
    """The design a call of M rows in ``dtype`` takes."""
    if m <= SKINNY_PICK_M[dtype]:
        return "skinny"
    return "ffma" if dtype == torch.float32 else "wgmma"


def norm_prologue_fits(m: int, k: int, dtype: torch.dtype) -> bool:
    """Whether a call of M rows of K in ``dtype`` keeps its norm in the
    kernel's prologue: the skinny design, up to :data:`SKINNY_NORM_MAX_K`."""
    return pick_design(m, dtype) == "skinny" and k <= SKINNY_NORM_MAX_K


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
                     out_dtype=None) -> torch.Tensor:
    """x: (M, K); w: (K, N); bias: (N,) -> (M, N).

    int8 W8A8 mode when scales are given: x and w int8, x_scale (M, 1)
    and w_scale (1, N) fp32 (wg_scale (1, N) too when gated); int32
    accumulation, dequant in the epilogue, fp32 output by default.
    w_gate: (K, N) second weight — gated mode, out = act(x@wg) * (x@w).
    residual: (M, N) added after activation/gating, before the cast.
    prologue: 'layer' | 'rms' — normalize the x rows in-kernel
    (gamma/pbeta: (K,)); float mode only.
    The design is :func:`pick_design`'s for M and the dtype.
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

    def note(design, splits=None):
        """The call's record (when recording): off the card (a CPU or
        meta tensor) ``launched`` False and the K splits of an H100."""
        if splits is None:
            n, k = w.shape[1], x.shape[1]
            splits = (skinny_splits(n, k, w_gate is not None, H100.sms)[0]
                      if design == "skinny" and n and k else 0)
        _build.note("rowwise_matmul", design, dict(
            x=x, w=w, w_gate=w_gate, bias=bias, bias_gate=bias_gate,
            residual=residual, gamma=gamma, pbeta=pbeta, x_scale=x_scale,
            w_scale=w_scale, wg_scale=wg_scale, out=out),
            launched=out.is_cuda, prologue=prologue, splits=splits)

    if x.device.type == "cpu":
        with _build.plain_call():
            out = ref.pipeline_ref(
                x, w, bias=bias, activation=activation, w_gate=w_gate,
                bias_gate=bias_gate, residual=residual, norm_kind=prologue,
                gamma=gamma, beta=pbeta, eps=eps, out_dtype=out_dtype,
                x_scale=x_scale, w_scale=w_scale, wg_scale=wg_scale)
        if _build.records is not None and x.dtype in _DT:
            note(pick_design(x.shape[0], x.dtype))
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
    design = pick_design(m, x.dtype)
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
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if not (m and n):
        return out
    if dev.type == "meta":
        # shapes alone (the dry run's): checked as for a launch, no launch
        if _build.records is not None:
            note(design)
        return out
    splits = kc = 0
    work = counters = None
    if design == "skinny":
        splits, kc, work, counters = _skinny_plan(dev, m, n, k,
                                                  w_gate is not None)
    err = _build.function("rk_rowwise_matmul", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), _build.ptr(w_gate),
        _build.ptr(vecs["bias"]), _build.ptr(vecs["bias_gate"]),
        _build.ptr(residual), _build.ptr(vecs["gamma"]),
        _build.ptr(vecs["pbeta"]), _build.ptr(x_scale), _build.ptr(w_scale),
        _build.ptr(wg_scale), out.data_ptr(), _build.ptr(work),
        _build.ptr(counters),
        x.stride(0), w.stride(0),
        w_gate.stride(0) if w_gate is not None else 0,
        residual.stride(0) if residual is not None else 0, out.stride(0),
        m, n, k, KINDS.get(prologue, 0), ACTIVATIONS[activation],
        _DT[x.dtype], _DT[residual.dtype] if residual is not None else 0,
        _DT[out_dtype], vec_bits, splits, kc, eps, DESIGNS[design],
        _build.stream(dev))
    _build.check(err, "rowwise_matmul_p")
    rowwise_matmul_p.launches += 1
    if _build.records is not None:
        note(design, splits)
    return out


rowwise_matmul_p.launches = 0
