"""Row-wise scheduling on the H100: the tile plan of the port's matmul.

The paper decomposes every dense op into one dot-product primitive on a
PE array whose weights are broadcast down its rows; the port runs that
primitive as ``rowwise_matmul_p``, four hand-written designs behind one
C entry point (``kernels/rowwise_matmul.py::pick_design``). This module
is the port's counterpart of the JAX package's ``core/rowwise.py``:
:func:`plan_matmul` returns, for ``x (M, K) @ w (K, N)``, the plan of the
design the wrapper really takes (skinny, wgmma, persistent or ffma): its
tile, grid,
padded dims, the utilization of the tiles it occupies (useful MACs over
the MACs of occupied tiles, the paper's utilization analysis), the waves
over the H100's 132 SMs, its shared memory, flops and modeled HBM bytes.

The tile constants below have one home here, each beside the ``.cu``
line it mirrors; ``analysis/smem.py`` holds them against the built
library (an exported query of each kernel's constants) on the card.

The hardware figures are the H100 SXM's (NVIDIA's data sheet, dense
peaks), not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HopperGeometry:
    """The H100 SXM as the planner and the roofline see it."""

    sms: int = 132
    smem_per_block: int = 232_448          # opt-in shared memory a block
    regs_per_sm: int = 65_536
    max_regs_per_thread: int = 255
    l2_bytes: int = 50 * 1000 ** 2
    hbm_bw: float = 3.35e12                # bytes/s
    peak_fp32: float = 67e12               # FLOP/s off the tensor cores
    peak_bf16: float = 989e12              # dense, tensor cores
    peak_int8: float = 1979e12             # dense, tensor cores
    nvlink_bw: float = 450e9               # bytes/s each way


H100 = HopperGeometry()

# The wgmma design (bf16 and int8 above the skinny rows):
# csrc/rowwise_matmul_wgmma.cu:50-56 (TM, KB, STAGES, WTHREADS) and :59
# (BN, 64 when gated).
WGMMA_TM = 128                 # tile rows
WGMMA_KB = 128                 # bytes of K a stage
WGMMA_STAGES = 5               # the TMA / mbarrier ring
WGMMA_BN = 128                 # tile columns
WGMMA_BN_GATED = 64            # gated: two weights' tiles a stage
WGMMA_THREADS = 384            # a producer and two consumer warpgroups
WGMMA_ALIGN = 1024             # the ring is aligned up to 1024 bytes
# The persistent design (the bf16 calls the route sends it):
# csrc/rowwise_matmul_persistent.cu:50-66.
PERSISTENT_TM = 128            # tile rows
PERSISTENT_KB = 128            # bytes of K a stage (64 bf16)
PERSISTENT_STAGES = 4          # the TMA / mbarrier ring
PERSISTENT_BN = 256            # tile columns where N % 256 == 0
PERSISTENT_BN_NARROW = 128     # else, and gated (w's and wg's tiles)
PERSISTENT_GROUP = 16          # row panels a group of the walk, at most
PERSISTENT_CLUSTER = 2         # blocks of a cluster: adjacent row panels,
                               # one weight tile (TMA multicast)
PERSISTENT_EPI_BYTES = 64 * 64 * 4   # a consumer's epilogue buffer
PERSISTENT_THREADS = 384       # a producer and two consumer warpgroups
# The ffma design (fp32 above the skinny rows): csrc/rowwise_matmul.cu:44
# (FT, FK, FTHREADS) and :84 (launch bounds: 2 blocks an SM gated, else
# 3).
FFMA_FT = 64                   # tile rows and columns
FFMA_FK = 16                   # K a step
FFMA_THREADS = 256
FFMA_MIN_BLOCKS = {False: 3, True: 2}
# The skinny design (M <= 16 fp32, M <= 4 bf16 / int8):
# csrc/rowwise_matmul_skinny.cu:37 (STHREADS, SUB, NB) and :71 (RG).
SKINNY_THREADS = 256
SKINNY_SUB = 512               # K rows of x staged a round
SKINNY_NB = 64                 # columns a block
SKINNY_RG = 4                  # rows a reduction round
# the blocks an SM the wrapper sizes its splits for
# (kernels/rowwise_matmul.py::_SKINNY_BLOCKS_PER_SM)
SKINNY_BLOCKS_PER_SM = 2
# the two row capacities the launcher instantiates (:249-251)
SKINNY_MAXM = (4, 16)
ROW_STATS_BYTES = 8            # rk::RowStats: mean, rstd (common.cuh:52)

DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
               torch.int8: "int8"}
DTYPE_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
_TORCH = {v: k for k, v in DTYPE_NAMES.items()}


def dtype_name(dtype) -> str:
    """'fp32' / 'bf16' / 'int8' for a torch dtype or such a name."""
    if isinstance(dtype, str):
        if dtype not in DTYPE_BYTES:
            raise ValueError(f"no matmul kernel for dtype {dtype!r}")
        return dtype
    if dtype not in DTYPE_NAMES:
        raise ValueError(f"no matmul kernel for {dtype}")
    return DTYPE_NAMES[dtype]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def wgmma_smem_bytes(n_weights: int = 1) -> int:
    """The wgmma launcher's dynamic shared-memory request, as the plan
    accounts for it: the 1024-byte alignment slack, the ring of
    ``WGMMA_STAGES`` stages (an x tile of TM rows and the weights' tiles
    of BN columns, KB bytes of K each), a full and an empty mbarrier a
    stage, and the row statistics of the norm prologue."""
    bn = WGMMA_BN_GATED if n_weights > 1 else WGMMA_BN
    stage = (WGMMA_TM + n_weights * bn) * WGMMA_KB
    return (WGMMA_ALIGN + WGMMA_STAGES * stage + 2 * WGMMA_STAGES * 8
            + WGMMA_TM * ROW_STATS_BYTES)


def persistent_smem_bytes() -> int:
    """The persistent launcher's dynamic shared-memory request: the
    alignment slack, the ring (an x tile of TM rows and 256 columns of
    weights a stage, KB bytes of K each), both consumers' epilogue
    buffers, and a full and an empty mbarrier a stage."""
    stage = (PERSISTENT_TM + PERSISTENT_BN) * PERSISTENT_KB
    return (WGMMA_ALIGN + PERSISTENT_STAGES * stage
            + 2 * PERSISTENT_EPI_BYTES + 2 * PERSISTENT_STAGES * 8)


def persistent_bn(n: int, gated: bool) -> int:
    """The persistent design's tile columns: 256 where N is a multiple
    of 256, else (and gated) 128."""
    return (PERSISTENT_BN if not gated and n % PERSISTENT_BN == 0
            else PERSISTENT_BN_NARROW)


def persistent_group(row_panels: int) -> int:
    """Units along M a group of the persistent walk holds: a unit is
    ``PERSISTENT_CLUSTER`` row panels, one a block of a cluster; up to
    ``PERSISTENT_GROUP`` row panels a group."""
    units = _cdiv(row_panels, PERSISTENT_CLUSTER)
    return min(units, PERSISTENT_GROUP // PERSISTENT_CLUSTER)


def persistent_walk(row_panels: int, col_panels: int,
                    group: int) -> List[Tuple[int, int]]:
    """(unit along M, column panel) of each unit index of the persistent
    walk (``origin`` in ``csrc/rowwise_matmul_persistent.cu``): groups of
    ``group`` units along M, each walked down its units, then along N;
    cluster c takes indices c, c + clusters, ..., and its block r the
    row panel ``PERSISTENT_CLUSTER`` x unit + r (none past the last)."""
    units = _cdiv(row_panels, PERSISTENT_CLUSTER)
    per_group = group * col_panels
    out = []
    for u in range(units * col_panels):
        g, within = divmod(u, per_group)
        first = g * group
        rows = min(group, units - first)
        out.append((first + within % rows, within // rows))
    return out


def ffma_smem_bytes(gated: bool) -> int:
    """The ffma kernel's static shared memory: the transposed x tile
    (padded by 4), the w tile and, gated, the gate's, double-buffered,
    and the row statistics (the ungated kernel's one-row stand-in for
    the gate's tile is never read, and the build drops it)."""
    xs = 2 * FFMA_FK * (FFMA_FT + 4) * 4
    ws = 2 * FFMA_FK * FFMA_FT * 4
    wgs = 2 * FFMA_FK * FFMA_FT * 4 if gated else 0
    return xs + ws + wgs + FFMA_FT * ROW_STATS_BYTES


def skinny_maxm(m: int) -> int:
    """The row capacity of the skinny instantiation M rows take."""
    return SKINNY_MAXM[0] if m <= SKINNY_MAXM[0] else SKINNY_MAXM[1]


def skinny_smem_bytes(maxm: int, dtype="bf16") -> int:
    """The skinny kernel's static shared memory: the staged x rows, the
    warps' partial sums, the row statistics of the norm prologue (none
    in int8, which takes no prologue: the build drops them) and the
    last-block flag."""
    rg = min(maxm, SKINNY_RG)
    stats = 0 if dtype_name(dtype) == "int8" else maxm * ROW_STATS_BYTES
    return (SKINNY_SUB * maxm * 4 + (SKINNY_THREADS // 32) * rg * SKINNY_NB
            * 4 + stats + 4)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The launch of one (M, K, N) matmul on the design the wrapper
    picks."""

    design: str             # 'skinny' | 'wgmma' | 'persistent' | 'ffma'
    bm: int                 # rows a tile
    bk: int                 # K a stage (skinny: a split's rows, kc)
    bn: int                 # columns a tile
    k_splits: int           # skinny's split-K; 1 elsewhere
    # (column tiles, row tiles or splits, z); persistent: (blocks, 1, 1),
    # one an SM in clusters of PERSISTENT_CLUSTER, walking units of that
    # many row panels in groups of ``group`` units along M
    grid: Tuple[int, int, int]
    m_pad: int
    k_pad: int
    n_pad: int
    utilization: float      # useful MACs / MACs of the occupied tiles
    blocks_per_sm: int      # resident blocks an SM the plan assumes
    # ceil(blocks / (SMs x blocks_per_sm)); persistent: the rounds of its
    # clusters over the walk's units
    waves: int
    threads: int
    stages: int             # K stages a block holds (ring, buffers)
    smem_dynamic: int       # the launcher's dynamic shared memory
    smem_static: int        # the kernel's static shared memory
    flops: int
    bytes_moved: int        # modeled HBM bytes, re-reads per tile included
    group: int = 0          # persistent: units along M a group of the walk

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def smem_bytes(self) -> int:
        return self.smem_dynamic + self.smem_static

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_moved, 1)


def pick(m: int, k: int, n: int, dtype, prologue: bool = False) -> str:
    """The design ``rowwise_matmul_p`` takes for ``x (M, K) @ w (K, N)``
    in ``dtype`` with operands TMA takes."""
    from repro_torch.kernels.rowwise_matmul import pick_design
    return pick_design(m, _TORCH[dtype_name(dtype)], n, k,
                       prologue=prologue)


def plan_matmul(m: int, k: int, n: int, *, dtype="bf16",
                n_weights: int = 1, residual: bool = False,
                prologue: bool = False, out_dtype=None, res_dtype=None,
                geom: HopperGeometry = H100,
                design: Optional[str] = None) -> TilePlan:
    """The plan of ``x (M, K) @ w (K, N)`` on the design
    :func:`pick` gives (or ``design``), its operands taken as TMA takes
    them.

    ``n_weights`` 2 is the gated gate|up call (two weight panels, one x);
    ``residual`` an (M, N) operand read once in the epilogue (priced at
    ``res_dtype``, default the output's); ``prologue`` the norm's fp32
    gamma and beta rows. ``out_dtype`` defaults to the input's (fp32 for
    int8).

    Modeled HBM bytes follow the tiles: a tile reads its x rows and its
    weight columns, so x is read once per column tile and the weights
    once per row tile (skinny: once, split over K, plus each split's
    fp32 or int32 partial sums written and read back when there are
    several); the output and the residual once. The 50 MB L2 may serve
    re-reads; the model counts them.
    """
    dt = dtype_name(dtype)
    db = DTYPE_BYTES[dt]
    ob = DTYPE_BYTES[dtype_name(out_dtype)] if out_dtype is not None \
        else (4 if dt == "int8" else db)
    rb = DTYPE_BYTES[dtype_name(res_dtype)] if res_dtype is not None \
        else ob
    design = design or pick(m, k, n, dt, prologue)
    gated = n_weights > 1
    group = 0
    if design == "wgmma":
        if dt == "fp32":
            raise ValueError("the wgmma design takes bf16 and int8")
        bm = WGMMA_TM
        bn = WGMMA_BN_GATED if gated else WGMMA_BN
        bk = WGMMA_KB // db
        splits, z = 1, 1
        m_pad, n_pad, k_pad = _round_up(m, bm), _round_up(n, bn), \
            _round_up(k, bk)
        grid = (n_pad // bn, m_pad // bm, 1)
        per_sm, threads, stages = 1, WGMMA_THREADS, WGMMA_STAGES
        dyn, static = wgmma_smem_bytes(n_weights), 0
    elif design == "persistent":
        if dt != "bf16" or prologue:
            raise ValueError("the persistent design takes bf16 with no "
                             "norm prologue")
        bm, bn = PERSISTENT_TM, persistent_bn(n, gated)
        bk = PERSISTENT_KB // db
        splits, z = 1, 1
        m_pad, n_pad, k_pad = _round_up(m, bm), _round_up(n, bn), \
            _round_up(k, bk)
        group = persistent_group(m_pad // bm)
        units = _cdiv(m_pad // bm, PERSISTENT_CLUSTER) * (n_pad // bn)
        clusters = geom.sms // PERSISTENT_CLUSTER
        grid = (PERSISTENT_CLUSTER * min(units, clusters), 1, 1)
        per_sm, threads = 1, PERSISTENT_THREADS
        stages = PERSISTENT_STAGES
        dyn, static = persistent_smem_bytes(), 0
    elif design == "ffma":
        if dt != "fp32":
            raise ValueError("the ffma design takes fp32")
        bm = bn = FFMA_FT
        bk = FFMA_FK
        splits, z = 1, 1
        m_pad, n_pad, k_pad = _round_up(m, bm), _round_up(n, bn), \
            _round_up(k, bk)
        grid = (n_pad // bn, m_pad // bm, 1)
        per_sm, threads = FFMA_MIN_BLOCKS[gated], FFMA_THREADS
        stages = 2
        dyn, static = 0, ffma_smem_bytes(gated)
    elif design == "skinny":
        from repro_torch.kernels.rowwise_matmul import skinny_splits
        maxm = skinny_maxm(m)
        if m > maxm:
            raise ValueError(f"the skinny design takes at most "
                             f"{SKINNY_MAXM[-1]} rows, not {m}")
        splits, kc = skinny_splits(n, k, gated, geom.sms)
        z = 2 if gated else 1
        bm, bn, bk = m, SKINNY_NB, kc
        m_pad = _round_up(m, min(maxm, SKINNY_RG))
        n_pad, k_pad = _round_up(n, bn), splits * kc
        grid = (n_pad // bn, splits, z)
        per_sm, threads = SKINNY_BLOCKS_PER_SM, SKINNY_THREADS
        stages = 1
        dyn, static = 0, skinny_smem_bytes(maxm, dt)
    else:
        raise ValueError(f"unknown matmul design {design!r}")
    useful = m * k * n
    occupied = m_pad * k_pad * n_pad
    row_tiles = m_pad // bm if design != "skinny" else 1
    col_tiles = n_pad // bn
    flops = 2 * useful * n_weights
    if design == "skinny":
        x_reads = col_tiles * z
        w_reads = 1
    else:
        x_reads = col_tiles
        w_reads = row_tiles
    nbytes = (m * k * db * x_reads + k * n * db * n_weights * w_reads
              + m * n * ob)
    if design == "skinny" and splits > 1:
        nbytes += 2 * splits * m * n * 4 * z      # partial sums out and in
    if residual:
        nbytes += m * n * rb
    if prologue:
        nbytes += 2 * k * 4
    if design == "persistent":
        waves = _cdiv(units, clusters)
    else:
        waves = _cdiv(grid[0] * grid[1] * grid[2], geom.sms * per_sm)
    return TilePlan(
        design=design, bm=bm, bk=bk, bn=bn, k_splits=splits, grid=grid,
        m_pad=m_pad, k_pad=k_pad, n_pad=n_pad,
        utilization=useful / occupied, blocks_per_sm=per_sm,
        waves=waves, threads=threads,
        stages=stages, smem_dynamic=dyn, smem_static=static, flops=flops,
        bytes_moved=nbytes, group=group)


# ----------------------------------------------------------------------
# Model-level schedule report (the paper's Section III/IV analysis):
# walk a model's GEMMs, plan each, aggregate utilization.
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str
    kind: str            # 'conv' | 'fc' | 'attn'
    m: int
    k: int
    n: int
    count: int = 1       # how many identical GEMMs (e.g. layers, windows)

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count


@dataclasses.dataclass
class ScheduleReport:
    ops: list
    plans: list

    @property
    def total_flops(self) -> int:
        return sum(2 * op.macs for op in self.ops)

    @property
    def utilization(self) -> float:
        useful = sum(op.macs for op in self.ops)
        occupied = sum(op.macs / max(p.utilization, 1e-12)
                       for op, p in zip(self.ops, self.plans))
        return useful / max(occupied, 1e-12)

    def dominant(self, frac: float = 0.97) -> dict:
        """FLOPs share per op kind (the paper's Fig. 2 claim)."""
        total = sum(op.macs for op in self.ops)
        shares = {}
        for op in self.ops:
            shares[op.kind] = shares.get(op.kind, 0) + op.macs / total
        return shares



def schedule_model(ops, **plan_kwargs) -> ScheduleReport:
    plans = [plan_matmul(op.m, op.k, op.n, **plan_kwargs) for op in ops]
    return ScheduleReport(ops=list(ops), plans=plans)
