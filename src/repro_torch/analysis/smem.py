"""Shared-memory and register budget pass, the port's counterpart of the
JAX package's ``analysis/vmem.py``.

The JAX package plans its row-wise kernels against a per-core VMEM
budget and recomputes each traced ``pallas_call``'s residency from its
block shapes. The port's kernels are CUDA C++ built for the H100, whose
budget is per block: 232,448 bytes of shared memory (static plus
dynamic), and 65,536 registers an SM shared by the blocks the kernel's
``__launch_bounds__`` promise to fit. This pass holds every kernel
instantiation the four pickers and the SSD scan can choose to that
budget.

On the CPU (:func:`kernel_models`, :func:`audit_models`,
:func:`crosscheck_plan`), from a model of each kernel's shared memory
written here from the sources (each figure names the ``.cu`` line it
mirrors):

  * RWA401: static + dynamic shared memory over 232,448 bytes;
  * RWA402: ``plan_matmul``'s accounting does not cover its design's
    launcher request.

On the card (:func:`audit_build`), against what the build reports:
``build/repro_torch/ptxas.log`` (:func:`parse_ptxas`: registers, static
shared memory and spill stores of every kernel) and each file's exported
query (``rk_query_*``: the launcher's dynamic request, set on the kernel
as the launcher sets it, then ``cudaFuncGetAttributes``):

  * RWA402: the modeled dynamic request differs from the launcher's,
    byte for byte, or a built kernel has no model, or a tile constant of
    ``core/rowwise.py`` differs from the library's;
  * RWA401: the built static plus the requested dynamic over budget;
  * RWA403: a kernel spills (ptxas' spill stores);
  * RWA404: registers x threads x the launch bounds' minimum blocks over
    65,536.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from typing import Dict, List, Optional

from repro_torch.analysis.report import Diagnostic, PassResult
from repro_torch.core import rowwise
from repro_torch.core.rowwise import H100

BUDGET = H100.smem_per_block

# csrc/flash_attention.cu:55-59 (BQ, BK, BIAS_PITCH), :188 and :345
# (NT), :347 (PP), :600 (the mma design's minimum blocks)
ATTN_BQ = 64
ATTN_BK = 64
ATTN_BIAS_PITCH = ATTN_BK + 8
ATTN_NT = 128
ATTN_FFMA_PP = 16 * 4 + 4
ATTN_HEAD_DIMS = (16, 32, 64, 128)
# csrc/layernorm.cu:51-63
LN_MAX_THREADS = 1024
LN_ROWS_SLOTS = 4
LN_ROWS_MAX_LANES = 256
LN_CTA_ELEMS = 16
LN_STAGE_BYTES = 227 * 1024 - 1024
LN_PART_BYTES = 64 * 4                 # __shared__ float part[64]
# csrc/wkv.cu:62-64 (L, W, THREADS), :176 (minimum blocks)
WKV_L = 16
WKV_W = 16
WKV_THREADS = 128
WKV_HEAD_DIMS = (16, 32, 64)
# csrc/ssd.cu:63-66 (THREADS, RT, LMAX, PITCH), the scan's two blocks an
# SM (its __launch_bounds__)
SSD_THREADS = 256
SSD_RT = 64
SSD_LMAX = 256
SSD_PITCH = SSD_RT + 4
SSD_HEAD_DIMS = (16, 32, 64)
SSD_STATE_DIMS = (16, 64, 128)

_SIZE = {"fp32": 4, "bf16": 2, "int8": 1}


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def attention_smem_bytes(hd: int, design: str) -> int:
    """``smem_bytes<Tile, HD>()`` (flash_attention.cu:519): two K/V
    stages and two Q tiles of rows padded by 16 bytes, the ffma design's
    P^T scratch, the mma design's bias cache."""
    t = 2 if design == "mma" else 4
    pitch = hd + 16 // t
    stage = 2 * ATTN_BK * pitch * t
    qtile = ATTN_BQ * pitch * t
    scratch = ATTN_BK * ATTN_FFMA_PP * 4 if design == "ffma" else 0
    bias = ATTN_BQ * ATTN_BIAS_PITCH * 4 if design == "mma" else 0
    return 2 * stage + 2 * qtile + scratch + bias


def wkv_smem_bytes(p: int, dtype: str) -> int:
    """``sizeof(ChunkSmem<T, P>)`` (wkv.cu:94): two stages of r/k/lw
    (W + PAD columns) and v (P + PAD), then the fp32 tiles."""
    t = _SIZE[dtype]
    pad = 16 // t
    stage = _align((3 * WKV_L * (WKV_W + pad) + WKV_L * (p + pad)) * t, t)
    floats = (2 * WKV_L * (p + 4) + 3 * WKV_W * (WKV_L + 4)
              + WKV_L * (WKV_W + 4) + WKV_W + WKV_L * (WKV_L + 4)
              + WKV_W * (p + 4)) * 4
    return _align(_align(2 * stage, 4) + floats, 4)


def ssd_cb_smem_bytes(n: int) -> int:
    """``cb_smem_bytes<N>()`` (ssd.cu): the B^T and C^T tiles, N rows of
    PITCH floats each."""
    return 2 * n * SSD_PITCH * 4


def ssd_scan_smem_bytes(p: int, n: int) -> int:
    """``sizeof(ScanSmem<P, N>)`` (ssd.cu): the state, two x tiles, two
    A / W tiles (pitch max(N, PITCH)) of a K-step (32, or 16 at N 16),
    the chunk's cs and dt; floats only, so no padding."""
    ks = 32 if n % 32 == 0 else 16
    return 4 * (n * p + 2 * ks * p + 2 * ks * max(n, SSD_PITCH)
                + 2 * SSD_LMAX)


@dataclasses.dataclass(frozen=True)
class KernelModel:
    """One kernel instantiation as the model sees it. ``name`` is the
    library query's name for it."""
    name: str
    source: str
    threads: int
    min_blocks: int
    dynamic: int            # the launcher's dynamic request
    static: int             # the kernel's static shared memory

    @property
    def smem(self) -> int:
        return self.dynamic + self.static


def kernel_models() -> List[KernelModel]:
    """Every kernel instantiation the four pickers and the SSD scan's
    launcher can choose."""
    out: List[KernelModel] = []
    for dt in ("bf16", "int8"):
        for gated in (False, True):
            out.append(KernelModel(
                f"rowwise_matmul_kernel_wgmma<{dt},{str(gated).lower()}>",
                "rowwise_matmul_wgmma.cu", rowwise.WGMMA_THREADS, 1,
                rowwise.wgmma_smem_bytes(2 if gated else 1), 0))
    for gated, bn in ((False, rowwise.PERSISTENT_BN),
                      (False, rowwise.PERSISTENT_BN_NARROW),
                      (True, rowwise.PERSISTENT_BN_NARROW)):
        out.append(KernelModel(
            f"rowwise_matmul_kernel_persistent<{str(gated).lower()},{bn}>",
            "rowwise_matmul_persistent.cu", rowwise.PERSISTENT_THREADS, 1,
            rowwise.persistent_smem_bytes(), 0))
    for gated in (False, True):
        out.append(KernelModel(
            f"rowwise_matmul_kernel<{str(gated).lower()}>",
            "rowwise_matmul.cu", rowwise.FFMA_THREADS,
            rowwise.FFMA_MIN_BLOCKS[gated], 0,
            rowwise.ffma_smem_bytes(gated)))
    for dt in ("fp32", "bf16", "int8"):
        for maxm in rowwise.SKINNY_MAXM:
            out.append(KernelModel(
                f"rowwise_matmul_kernel_skinny<{dt},{maxm}>",
                "rowwise_matmul_skinny.cu", rowwise.SKINNY_THREADS, 1, 0,
                rowwise.skinny_smem_bytes(maxm, dt)))
    for design in ("mma", "ffma"):
        for hd in ATTN_HEAD_DIMS:
            blocks = (4 if hd <= 64 else 2) if design == "mma" else 1
            out.append(KernelModel(
                f"attention_kernel_{design}<{hd}>", "flash_attention.cu",
                ATTN_NT, blocks, attention_smem_bytes(hd, design), 0))
    for dt in ("fp32", "bf16"):
        for nv in (1, 2, LN_ROWS_SLOTS):
            out.append(KernelModel(
                f"layernorm_kernel_rows<{dt},{nv}>", "layernorm.cu",
                LN_ROWS_MAX_LANES, 1, 0, LN_PART_BYTES))
    for dt in ("fp32", "bf16"):
        for nv in sorted({1, 2, LN_CTA_ELEMS // (16 // _SIZE[dt])}):
            out.append(KernelModel(
                f"layernorm_kernel_cta<{dt},{nv}>", "layernorm.cu",
                LN_MAX_THREADS, 1, 0, LN_PART_BYTES))
        for stage in (True, False):
            out.append(KernelModel(
                f"layernorm_kernel_cta_wide<{dt},{str(stage).lower()}>",
                "layernorm.cu", LN_MAX_THREADS, 1,
                LN_STAGE_BYTES if stage else 0, LN_PART_BYTES))
    for dt in ("fp32", "bf16"):
        for p in WKV_HEAD_DIMS:
            out.append(KernelModel(
                f"wkv_kernel_chunk<{dt},{p}>", "wkv.cu", WKV_THREADS,
                6 if dt == "fp32" and p == 64 else 4,
                wkv_smem_bytes(p, dt), 0))
    for dt in ("fp32", "bf16"):
        for p in WKV_HEAD_DIMS:
            out.append(KernelModel(f"wkv_kernel_step<{dt},{p}>", "wkv.cu",
                                   4 * p, 1, 0, 0))
    for n in SSD_STATE_DIMS:
        out.append(KernelModel(f"ssd_cb_kernel<{n}>", "ssd.cu", SSD_THREADS,
                               1, ssd_cb_smem_bytes(n), 0))
    for p in SSD_HEAD_DIMS:
        for n in SSD_STATE_DIMS:
            out.append(KernelModel(f"ssd_scan_kernel<{p},{n}>", "ssd.cu",
                                   SSD_THREADS, 2, ssd_scan_smem_bytes(p, n),
                                   0))
    return out


def audit_models(models, *, budget: int = BUDGET,
                 name: str = "model") -> PassResult:
    """RWA401 for every modeled kernel over the budget."""
    result = PassResult(name="smem")
    for m in models:
        result.checked += 1
        if m.smem > budget:
            result.diagnostics.append(Diagnostic(
                code="RWA401", path=name,
                message=f"kernel `{m.name}` holds {m.smem:,} B of shared "
                        f"memory ({m.static:,} static + {m.dynamic:,} "
                        f"dynamic) > {budget:,} B a block"))
    return result


def model_of(plan, n_weights: int = 1, dtype: str = "bf16") -> KernelModel:
    """The kernel model a matmul plan's launch takes."""
    by_name = {m.name: m for m in kernel_models()}
    gated = str(n_weights > 1).lower()
    if plan.design == "wgmma":
        return by_name[f"rowwise_matmul_kernel_wgmma<{dtype},{gated}>"]
    if plan.design == "persistent":
        return by_name[
            f"rowwise_matmul_kernel_persistent<{gated},{plan.bn}>"]
    if plan.design == "ffma":
        return by_name[f"rowwise_matmul_kernel<{gated}>"]
    maxm = rowwise.skinny_maxm(plan.bm)
    return by_name[f"rowwise_matmul_kernel_skinny<{dtype},{maxm}>"]


def crosscheck_plan(plan, model: KernelModel, *, name: str = "matmul",
                    budget: int = BUDGET) -> PassResult:
    """RWA402 when the plan's shared-memory accounting does not cover its
    kernel's (the plan's occupancy and waves are built on it); RWA401
    for either over the budget."""
    result = audit_models([model], budget=budget, name=name)
    result.checked += 2
    if plan.smem_dynamic < model.dynamic or plan.smem_static < model.static:
        result.diagnostics.append(Diagnostic(
            code="RWA402", path=name,
            message=f"kernel `{model.name}` takes {model.dynamic:,} B "
                    f"dynamic + {model.static:,} B static, its plan "
                    f"accounts {plan.smem_dynamic:,} + "
                    f"{plan.smem_static:,}: plan_matmul undercounts"))
    if plan.smem_bytes > budget:
        result.diagnostics.append(Diagnostic(
            code="RWA401", path=name,
            message=f"plan of {plan.design} holds {plan.smem_bytes:,} B > "
                    f"{budget:,} B a block"))
    return result


# ----------------------------------------------------------------------
# The build: ptxas' report and the library's query
# ----------------------------------------------------------------------


@dataclasses.dataclass
class PtxasEntry:
    source: str
    name: str               # the mangled kernel name
    registers: int = 0
    smem: int = 0           # static shared bytes
    spill_stores: int = 0
    spill_loads: int = 0
    entry: bool = True      # a kernel, else a device function


def parse_ptxas(log: str) -> List[PtxasEntry]:
    """Every entry function of ``_build.py``'s ``ptxas.log`` (the ``==
    <file>`` sections of ``nvcc -Xptxas -v``): its registers, static
    shared memory and spills."""
    out: List[PtxasEntry] = []
    source, cur = "", None
    for line in log.splitlines():
        head = re.match(r"== (\S+)", line)
        if head:
            source = head.group(1)
            continue
        found = re.search(r"Compiling entry function '(\S+?)'", line)
        if found:
            cur = PtxasEntry(source, found.group(1))
            out.append(cur)
            continue
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            cur = next((e for e in out if e.name == found.group(1)
                        and e.source == source), None)
            if cur is None:
                cur = PtxasEntry(source, found.group(1), entry=False)
                out.append(cur)
            continue
        if cur is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found:
            cur.spill_stores, cur.spill_loads = map(int, found.groups())
        found = re.search(r"Used (\d+) registers", line)
        if found:
            cur.registers = int(found.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur.smem = int(smem.group(1)) if smem else 0
    return out


def spills(entries: List[PtxasEntry]) -> List[tuple]:
    """(kernel, spill stores, spill loads) of every kernel that spills."""
    return [(e.name, e.spill_stores, e.spill_loads) for e in entries
            if e.spill_stores or e.spill_loads]


# the library's query functions (rk_query_*), by source file
QUERIES = {"rowwise_matmul_wgmma.cu": "rk_query_wgmma",
           "rowwise_matmul_persistent.cu": "rk_query_persistent",
           "rowwise_matmul.cu": "rk_query_ffma",
           "rowwise_matmul_skinny.cu": "rk_query_skinny",
           "flash_attention.cu": "rk_query_attention",
           "layernorm.cu": "rk_query_layernorm",
           "wkv.cu": "rk_query_wkv",
           "ssd.cu": "rk_query_ssd"}
_FIELDS = ("threads", "min_blocks", "dynamic", "static", "registers",
           "local_bytes", "max_dynamic", "max_threads")


@dataclasses.dataclass
class Built:
    name: str
    source: str
    threads: int
    min_blocks: int
    dynamic: int
    static: int
    registers: int
    local_bytes: int
    max_dynamic: int
    max_threads: int
    error: int = 0


def _query(lib, fn_name: str):
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_char_p
    return fn


def query_library(lib) -> List[Built]:
    """Every kernel the library reports, with its build's attributes."""
    out: List[Built] = []
    for source, fn_name in QUERIES.items():
        fn = _query(lib, fn_name)
        i = 0
        while True:
            buf = (ctypes.c_longlong * 8)()
            err = ctypes.c_int(0)
            name = fn(i, buf, ctypes.byref(err))
            if name is None:
                break
            out.append(Built(name.decode(), source, *list(buf),
                             error=err.value))
            i += 1
    return out


def library_constants(lib) -> Dict[str, Dict[str, int]]:
    """Each file's constants as the library reports them (query -1)."""
    out = {}
    for source, fn_name in QUERIES.items():
        buf = (ctypes.c_longlong * 16)()
        err = ctypes.c_int(0)
        names = _query(lib, fn_name)(-1, buf, ctypes.byref(err)).decode()
        out[source] = dict(zip(names.split(","), list(buf)))
    return out


# the plan's tile constants against the library's, by file
PLAN_CONSTANTS = {
    "rowwise_matmul_wgmma.cu": {
        "TM": rowwise.WGMMA_TM, "KB": rowwise.WGMMA_KB,
        "STAGES": rowwise.WGMMA_STAGES, "BN": rowwise.WGMMA_BN,
        "BN_GATED": rowwise.WGMMA_BN_GATED,
        "WTHREADS": rowwise.WGMMA_THREADS,
        "SMEM_BYTES": rowwise.wgmma_smem_bytes()},
    "rowwise_matmul_persistent.cu": {
        "TM": rowwise.PERSISTENT_TM, "KB": rowwise.PERSISTENT_KB,
        "STAGES": rowwise.PERSISTENT_STAGES, "BN": rowwise.PERSISTENT_BN,
        "BN_NARROW": rowwise.PERSISTENT_BN_NARROW,
        "GROUP": rowwise.PERSISTENT_GROUP,
        "CLUSTER": rowwise.PERSISTENT_CLUSTER,
        "PTHREADS": rowwise.PERSISTENT_THREADS,
        "SMEM_BYTES": rowwise.persistent_smem_bytes()},
    "rowwise_matmul.cu": {"FT": rowwise.FFMA_FT, "FK": rowwise.FFMA_FK,
                          "FTHREADS": rowwise.FFMA_THREADS},
    "rowwise_matmul_skinny.cu": {"STHREADS": rowwise.SKINNY_THREADS,
                                 "SUB": rowwise.SKINNY_SUB,
                                 "NB": rowwise.SKINNY_NB},
    "flash_attention.cu": {"BQ": ATTN_BQ, "BK": ATTN_BK,
                           "BIAS_PITCH": ATTN_BIAS_PITCH,
                           "MMA_NT": ATTN_NT, "FFMA_NT": ATTN_NT,
                           "FFMA_SCRATCH": ATTN_BK * ATTN_FFMA_PP * 4},
    "layernorm.cu": {"MAX_THREADS": LN_MAX_THREADS,
                     "ROWS_SLOTS": LN_ROWS_SLOTS,
                     "ROWS_MAX_LANES": LN_ROWS_MAX_LANES,
                     "CTA_ELEMS": LN_CTA_ELEMS,
                     "STAGE_BYTES": LN_STAGE_BYTES},
    "wkv.cu": {"L": WKV_L, "W": WKV_W, "THREADS": WKV_THREADS},
    "ssd.cu": {"THREADS": SSD_THREADS, "RT": SSD_RT, "LMAX": SSD_LMAX,
               "PITCH": SSD_PITCH},
}


def check_constants(lib_constants: Dict[str, Dict[str, int]]) \
        -> PassResult:
    """RWA402 for every constant of :data:`PLAN_CONSTANTS` the library
    disagrees with."""
    result = PassResult(name="smem")
    for source, want in PLAN_CONSTANTS.items():
        got = lib_constants.get(source, {})
        for key, value in want.items():
            result.checked += 1
            if got.get(key) != value:
                result.diagnostics.append(Diagnostic(
                    code="RWA402", path=source,
                    message=f"{key}: the model says {value}, the library "
                            f"{got.get(key)}"))
    return result


def audit_build(built: List[Built], ptxas: List[PtxasEntry],
                models: Optional[List[KernelModel]] = None, *,
                budget: int = BUDGET) -> PassResult:
    """The card's half: every built kernel against its model and the
    H100's budget (module docstring)."""
    result = PassResult(name="smem")
    models = {m.name: m for m in (models or kernel_models())}

    def diag(code, path, msg, severity="error"):
        result.diagnostics.append(Diagnostic(code=code, path=path,
                                             message=msg,
                                             severity=severity))
    for b in built:
        result.checked += 1
        if b.error:
            diag("RWA402", b.name, f"the library's query failed (CUDA "
                                   f"error {b.error})")
            continue
        m = models.get(b.name)
        if m is None:
            diag("RWA402", b.name, "a built kernel has no model")
            continue
        if (m.dynamic, m.threads, m.min_blocks) != (
                b.dynamic, b.threads, b.min_blocks):
            diag("RWA402", b.name,
                 f"modeled dynamic {m.dynamic:,} B, {m.threads} threads, "
                 f"{m.min_blocks} blocks; the launcher requests "
                 f"{b.dynamic:,} B, {b.threads} threads, {b.min_blocks} "
                 "blocks")
        if b.dynamic and b.max_dynamic != b.dynamic:
            diag("RWA402", b.name,
                 f"the launcher's request {b.dynamic:,} B, the kernel's "
                 f"attribute {b.max_dynamic:,} B")
        if m.static != b.static:
            diag("RWA402", b.name,
                 f"modeled static {m.static:,} B, built {b.static:,} B",
                 severity="warning")
        if b.static + b.dynamic > budget:
            diag("RWA401", b.name,
                 f"{b.static:,} B static + {b.dynamic:,} B dynamic > "
                 f"{budget:,} B a block")
        if b.registers * b.threads * b.min_blocks > H100.regs_per_sm:
            diag("RWA404", b.name,
                 f"{b.registers} registers x {b.threads} threads x "
                 f"{b.min_blocks} blocks > {H100.regs_per_sm:,}")
    for e in ptxas:
        result.checked += 1
        if e.spill_stores or e.spill_loads:
            diag("RWA403", e.name,
                 f"{e.spill_stores} bytes spill stores, {e.spill_loads} "
                 "bytes spill loads")
        if e.entry and e.smem > budget:
            diag("RWA401", e.name, f"{e.smem:,} B static > {budget:,} B")
    # every built kernel of a file is one the query reports
    for source in QUERIES:
        n_ptxas = sum(e.source == source and e.entry for e in ptxas)
        n_query = sum(b.source == source for b in built)
        result.checked += 1
        if n_ptxas != n_query:
            diag("RWA402", source,
                 f"ptxas.log holds {n_ptxas} kernels, the library's query "
                 f"reports {n_query}")
    return result


# the large-K stress shape (the JAX package's audit: its adder-tree
# K-split's reason to exist): K = 16384, cross-checked against its plan
STRESS = (256, 16384, 512)


def stress_plan(dtype: str = "fp32"):
    m, k, n = STRESS
    plan = rowwise.plan_matmul(m, k, n, dtype=dtype)
    return plan, model_of(plan, 1, dtype)
