"""Logical-axis partitioning over ``torch.distributed``, and the
tensor-parallel shard context of serving.

The port's copy of the JAX package's ``core/partitioning.py``. There
GSPMD places every array by its logical axis names; here each rank of a
process group holds its own block of every leaf and the model gathers
what it reads by hand:

  * **Rules and resolve** — ``DEFAULT_RULES`` maps logical names
    (``batch``, ``embed``, ``vocab``, ``experts``, ...) to mesh axes;
    :func:`resolve` turns a tuple of names into a spec (a tuple with one
    entry a dim: ``None``, an axis name or a tuple of them), spec for
    spec the JAX package's ``PartitionSpec``: shape-aware (an axis that
    does not divide the dim, cumulatively, is dropped before it is
    marked used), each axis used once, and the manual axes of an
    enclosing context (``pod`` under cross-pod compression) excluded.
    :func:`tree_shardings` resolves a tree of logical specs to a tree of
    :class:`Sharding`.
  * **The mesh** — :class:`Mesh` names the axes of a world of ranks
    (row-major over ``torch.distributed`` ranks, as
    ``init_device_mesh`` lays them out) and holds a process group for
    every set of its axes; :class:`MeshShape` is the same without
    processes, for resolving alone.
  * **Blocks** — :func:`shard_leaf` cuts this rank's block of a full
    leaf (the JAX layout: a dim over axes ``(a, b)`` splits into
    ``n_a * n_b`` blocks, ``a`` major); :func:`gather_leaf` is an
    autograd function, an all-gather forward and a reduce-scatter
    backward over the leaf's axes, so the gradient of a gathered leaf
    arrives as this rank's block summed over the group.
  * **FSDP by hand** — :func:`fsdp` registers the leaves of a sharded
    parameter tree; the model reads each through :func:`gathered` (a
    stacked leaf one repeat at a time, inside the repeat's
    recomputation), which gathers a registered leaf and passes any
    other through. Expert dims stay local: the expert-parallel MoE
    reads its own experts.
  * **Activations** — the port splits the batch alone (the step's
    :func:`batch_split`); :func:`logical_constraint` is a no-op, as the
    JAX package's is without a mesh: under GSPMD it only places
    activations. Ranks along a mesh axis the batch could not use hold
    the same rows; :func:`batch_replicas` counts them so that a loss
    counts each row once.

Every collective goes through one wrapper that counts its launches in
``launches`` (as the kernel wrappers do). A gloo group takes CUDA
tensors through host memory (staged, counted in ``staged.launches``);
an NCCL group stages nothing, and no wrapper ever replaces a
collective with local work.

The TP hooks of serving: every rank of a group runs the model on its
own shard, and the context names the group the row-parallel output
projections (attention ``wo``, the MLP down projection) sum their
K-partial outputs over (:func:`tp_reduce`) before the residual is
added, and the vocab-sharded head gathers its logit blocks over
(:func:`tp_gather`). ``serve/placement.py`` opens the context around
the engine's model calls; with no group active every hook is a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib

# logical name -> mesh axis (or tuple of axes), the JAX package's
DEFAULT_RULES = {
    # activations: batch over (pod, data, model), sequence over model;
    # parameters: d_model over both data and model (FSDP), vocab over
    # model; MoE: experts over model (expert parallel) when divisible
    "batch": ("pod", "data", "model"),
    "seq": "model",
    "act_embed": None,
    "vocab_act": "model",
    "embed": ("data", "model"),
    "vocab": "model",
    # the fused panels' N axes (q|k|v, gate|up) stay replicated
    "qkv": None,
    "ffn": None,
    "experts": "model",
    "heads": "model",
    "kv_heads": None,
    "kv_seq": None,          # "model" for the sequence-sharded decode
    "layers": None,
    "conv": None,
}

_ACTIVE: dict = {"tp_group": None, "mesh": None,
                 "rules": dict(DEFAULT_RULES), "manual": frozenset(),
                 "fsdp": None, "batch_axes": ()}


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------


class MeshShape:
    """Named axes and their sizes, without processes: enough to
    resolve specs."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        self.sizes = dict(zip(self.axis_names, self.shape))
        self.size = math.prod(self.shape)

    def describe(self) -> str:
        return f"mesh {self.sizes} = {self.size} ranks"


def _coords(rank: int, shape) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in a mesh of ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


class Mesh(MeshShape):
    """This rank's place in a mesh over the initialised default process
    group: ranks laid out row-major over the axes, a
    ``torch.distributed.device_mesh.DeviceMesh`` for them (its
    single-axis groups), and a group for every other set of axes. Every
    rank must build the same meshes in the same order: each creates its
    process groups. A world of the wrong size raises."""

    def __init__(self, shape, axis_names, device_type: Optional[str] = None):
        super().__init__(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError(f"a mesh {self.sizes} needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a mesh {self.sizes} needs {self.size} ranks; "
                             f"the world has {world}")
        from torch.distributed.device_mesh import init_device_mesh
        self.backend = dist.get_backend()
        device_type = device_type or (
            "cuda" if self.backend == "nccl" else "cpu")
        self.device_mesh = init_device_mesh(
            device_type, self.shape, mesh_dim_names=self.axis_names)
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, _coords(self.rank,
                                                        self.shape)))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if k == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                # one group per position on the other axes, ranks in
                # row-major order (so a group rank is its coordinates
                # over ``axes``, mesh order, the first major)
                lists = {}
                for r in range(self.size):
                    c = dict(zip(self.axis_names, _coords(r, self.shape)))
                    key = tuple(c[a] for a in self.axis_names
                                if a not in axes)
                    lists.setdefault(key, []).append(r)
                mine, _ = dist.new_subgroups_by_enumeration(
                    list(lists.values()))
                self._groups[axes] = mine

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axes) -> Any:
        """The process group over ``axes`` holding this rank."""
        axes = tuple(a for a in self.axis_names if a in set(axes))
        return self._groups[axes]

    def describe(self) -> str:
        return (f"mesh {self.sizes} = {self.size} ranks over "
                f"{self.backend}; this rank {self.rank} at {self.coords}")


# ----------------------------------------------------------------------
# Rules, the active mesh, resolve
# ----------------------------------------------------------------------


def set_rules(overrides: dict) -> None:
    _ACTIVE["rules"].update(overrides)


def get_rules() -> dict:
    return dict(_ACTIVE["rules"])


@contextlib.contextmanager
def use_mesh(mesh: Optional[MeshShape], rules: Optional[dict] = None):
    """Run the enclosed calls on ``mesh`` under ``rules`` (overrides of
    the defaults)."""
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    if rules:
        _ACTIVE["rules"] = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(prev)


def active_mesh() -> Optional[MeshShape]:
    return _ACTIVE["mesh"]


@contextlib.contextmanager
def manual_axes(axes):
    """Mark ``axes`` manual, as an enclosing ``shard_map`` does in the
    JAX package: :func:`resolve` never assigns them, and the mesh-wide
    reductions of the enclosed code stay inside one position on them
    (each pod of the compressed step is a mesh of its own)."""
    prev = _ACTIVE["manual"]
    _ACTIVE["manual"] = frozenset(prev) | frozenset(axes)
    try:
        yield
    finally:
        _ACTIVE["manual"] = prev


def auto_axes(mesh: Optional[MeshShape] = None) -> Tuple[str, ...]:
    """The mesh's axes that are not manual, in mesh order."""
    mesh = mesh or _ACTIVE["mesh"]
    return tuple(a for a in mesh.axis_names if a not in _ACTIVE["manual"])


def resolve(spec_names, mesh: Optional[MeshShape] = None,
            shape=None) -> tuple:
    """Logical names -> a spec under the active rules and mesh (an axis
    name, a tuple of them or None for each dim; None for every dim
    without a mesh). Shape-aware: when ``shape`` is given, axes that do
    not divide the dim (cumulatively) are dropped *before* being marked
    used, so ``batch=(pod,data,model)`` at a batch smaller than the mesh
    frees ``model`` for a later dim."""
    mesh = mesh or _ACTIVE["mesh"]
    rules = _ACTIVE["rules"]
    sizes = mesh.sizes if mesh is not None else {}
    used = set(_ACTIVE["manual"])
    out = []
    for i, name in enumerate(spec_names):
        ax = rules.get(name) if name else None
        dim = shape[i] if shape is not None and i < len(shape) else None
        cand = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        kept, prod = [], 1
        for a in cand:
            if a is None or a in used or a not in sizes:
                continue
            if dim is not None and dim % (prod * sizes[a]) != 0:
                continue
            kept.append(a)
            prod *= sizes[a]
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one entry of a spec."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_constraint(x, *names):
    """The JAX package's ``with_sharding_constraint`` by logical names.
    A no-op: GSPMD uses it to place activations, and the port's
    activations are each rank's rows of the batch, as
    :func:`batch_split` cut them."""
    return x


# ----------------------------------------------------------------------
# Spec trees and shardings
# ----------------------------------------------------------------------


def _is_spec_leaf(x) -> bool:
    """A logical spec leaf: a plain tuple of axis names (not a named
    tuple); ``()`` is the spec of a scalar."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def map_specs(fn, specs, *likes):
    """``fn(spec, *like_subtrees)`` at each spec leaf of ``specs``; the
    result has the spec tree's structure."""
    if _is_spec_leaf(specs):
        return fn(specs, *likes)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in likes))
                for k in specs}
    items = [map_specs(fn, s, *(t[i] for t in likes))
             for i, s in enumerate(specs)]
    return type(specs)(*items) if hasattr(specs, "_fields") \
        else type(specs)(items)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leaf's placement: its mesh, its resolved spec (one entry a dim)
    and its logical names."""
    mesh: MeshShape
    spec: tuple
    names: tuple = ()

    def axes(self) -> Tuple[str, ...]:
        """Every axis the leaf is split over, in mesh order."""
        used = {a for e in self.spec for a in spec_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def local_shape(self, shape) -> tuple:
        return tuple(n // math.prod(self.mesh.sizes[a] for a in spec_axes(e))
                     for n, e in zip(shape, self.spec))


def tree_shardings(mesh: MeshShape, logical_tree, like=None):
    """Resolve a tree of logical specs to a tree of :class:`Sharding`.
    With ``like`` (a tree of tensors of the global shapes), axes that do
    not divide a dim are dropped, dim by dim."""
    def one(names, ref=None):
        shape = None if ref is None else tuple(ref.shape)
        return Sharding(mesh, resolve(tuple(names), mesh, shape=shape),
                        tuple(names))
    if like is None:
        return map_specs(one, logical_tree)
    return map_specs(one, logical_tree, like)


def _block_index(mesh: Mesh, entry) -> Tuple[int, int]:
    """(this rank's block, block count) of a dim split over ``entry``'s
    axes (the first axis major)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx = idx * mesh.sizes[a] + mesh.coords[a]
        n *= mesh.sizes[a]
    return idx, n


def shard_leaf(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` (a copy: the full leaf
    can be freed)."""
    for d, entry in enumerate(sharding.spec):
        idx, n = _block_index(sharding.mesh, entry)
        if n > 1:
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {entry}")
            step = x.shape[d] // n
            x = x.narrow(d, idx * step, step)
    return x.clone()


def shard_tree(tree, shardings):
    """:func:`shard_leaf` over a tree (``shardings`` of its structure)."""
    return tree_lib.tree_map(shard_leaf, tree, shardings)


def full_leaf(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole leaf from this rank's block ``x`` (every rank of its
    group calls it), without a gradient."""
    if not sharding.axes():
        return x
    with torch.no_grad():
        return _gather(x, sharding.mesh, sharding.spec)


def gather_tree(tree, shardings):
    """The whole leaves of a sharded tree, one leaf at a time, on every
    rank (no gradient)."""
    return tree_lib.tree_map(full_leaf, tree, shardings)


# ----------------------------------------------------------------------
# The collectives: one wrapper each, counted, staged through the host
# for a gloo group's CUDA tensors
# ----------------------------------------------------------------------

_BACKENDS: dict = {}


def _staged(group, t: torch.Tensor) -> bool:
    if not t.is_cuda:
        return False
    key = id(group)
    if key not in _BACKENDS:
        _BACKENDS[key] = dist.get_backend(group)
    return _BACKENDS[key] == "gloo"


def staged():
    """Counts the collectives a gloo group ran on CUDA tensors through
    host memory (``staged.launches``)."""


def _collective(fn, out: torch.Tensor, inp: torch.Tensor, group):
    """``fn(out, inp)`` over ``group``; a gloo group's CUDA tensors go
    through host copies."""
    if not _staged(group, inp):
        fn(out, inp)
        return out
    staged.launches += 1
    host_out = out.cpu()
    fn(host_out, inp.cpu())
    out.copy_(host_out)
    return out


# the names of torch >= 2.13, and of the releases before it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(out, inp, group):
    """``out`` (G * n0, ...) <- every group rank's ``inp`` (n0, ...), in
    group-rank order."""
    all_gather.launches += 1
    all_gather.bytes += _nbytes(out)
    return _collective(lambda o, i: _ALL_GATHER(
        o, i.contiguous(), group=group), out, inp, group)


def reduce_scatter(out, inp, group):
    """``out`` (n0, ...) <- the sum over the group of block ``rank`` of
    ``inp`` (G * n0, ...)."""
    reduce_scatter.launches += 1
    reduce_scatter.bytes += _nbytes(out)
    return _collective(lambda o, i: _REDUCE_SCATTER(
        o, i.contiguous(), group=group), out, inp, group)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``t`` reduced over the group, in place."""
    all_reduce.launches += 1
    all_reduce.bytes += _nbytes(t)

    def run(o, i):
        dist.all_reduce(o, op=op, group=group)
    if not _staged(group, t):
        run(t, t)
        return t
    staged.launches += 1
    host = t.cpu()
    run(host, host)
    t.copy_(host)
    return t


def all_to_all(out, inp, group):
    """``out[i]`` <- block ``rank`` of group rank i's ``inp`` (both
    (G, ...))."""
    all_to_all.launches += 1
    all_to_all.bytes += _nbytes(out)
    return _collective(lambda o, i: dist.all_to_all_single(
        o, i.contiguous(), group=group), out, inp, group)


COLLECTIVES = (all_gather, reduce_scatter, all_reduce, all_to_all)


def reset_counts():
    for c in COLLECTIVES + (staged,):
        c.launches = 0
    for c in COLLECTIVES + (tp_reduce, tp_gather):
        c.bytes = 0


def counts() -> dict:
    return {c.__name__: c.launches for c in COLLECTIVES + (staged,)}


def byte_counts() -> dict:
    """The bytes each collective wrapper delivered since
    :func:`reset_counts`, by wrapper: the output of each call (the
    gathered tensor, the reduced shard, the reduced buffer, the
    exchanged blocks), the JAX package's convention for its HLO
    collectives (``launch/roofline.py::collective_bytes``)."""
    return {c.__name__: c.bytes for c in COLLECTIVES + (tp_reduce,
                                                        tp_gather)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ----------------------------------------------------------------------
# Gathers: the full leaf from the blocks, and its gradient back
# ----------------------------------------------------------------------


def _layout(mesh: Mesh, spec):
    """(group axes in mesh order, the permutation from the gathered
    blocks (group axes..., local dims...) to (per dim: its axes in spec
    order, its local dim))."""
    axes = tuple(a for a in mesh.axis_names
                 if a in {x for e in spec for x in spec_axes(e)})
    perm = []
    for d, entry in enumerate(spec):
        perm += [axes.index(a) for a in spec_axes(entry)]
        perm.append(len(axes) + d)
    return axes, perm


def _gather(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    axes, perm = _layout(mesh, spec)
    sizes = [mesh.sizes[a] for a in axes]
    g = math.prod(sizes)
    x = x.contiguous()
    out = x.new_empty((g * x.shape[0],) + tuple(x.shape[1:])) if x.dim() \
        else x.new_empty((g,))
    all_gather(out, x.reshape(-1) if not x.dim() else x, mesh.group(axes))
    full = out.reshape(sizes + list(x.shape)).permute(perm)
    shape = [n * math.prod(mesh.sizes[a] for a in spec_axes(e))
             for n, e in zip(x.shape, spec)]
    return full.reshape(shape)


def _scatter(g: torch.Tensor, mesh: Mesh, spec, local_shape):
    """The gradient of :func:`_gather`: this rank's block of the sum of
    the group's ``g``."""
    axes, perm = _layout(mesh, spec)
    sizes = [mesh.sizes[a] for a in axes]
    split = []
    for n, e in zip(local_shape, spec):
        split += [mesh.sizes[a] for a in spec_axes(e)] + [n]
    blocks = g.reshape(split).permute(
        [perm.index(i) for i in range(len(perm))]).contiguous()
    out = g.new_empty(tuple(local_shape))
    reduce_scatter(out, blocks.reshape((-1,) + tuple(local_shape[1:])),
                   mesh.group(axes))
    # the block keeps the layout of the full gradient (a transposed read's
    # is transposed), so that the sums made of it downstream (the
    # gradient of a leaf read twice, the global norm) add in the order
    # they add on one device
    return like_layout(out, g)


def memory_order(t: torch.Tensor):
    """The dims of ``t`` from the outermost in memory to the innermost."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def like_layout(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` laid out in memory as ``ref`` is (its dims in ref's memory
    order); ``x`` itself when that is its layout."""
    order = memory_order(ref)
    if order == memory_order(x):
        return x
    laid = x.new_empty([x.shape[d] for d in order]).permute(
        [order.index(d) for d in range(x.dim())])
    return laid.copy_(x)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, tuple(x.shape)
        return _gather(x, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.spec, ctx.shape), None, None


def gather_leaf(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The full leaf of this rank's block ``x``: an all-gather over the
    leaf's axes (one launch, also over a one-rank group) whose gradient
    is a reduce-scatter back to the block."""
    if not sharding.axes():
        return x
    return _Gather.apply(x, sharding.mesh, sharding.spec)


# ----------------------------------------------------------------------
# FSDP: the registry of sharded parameter leaves
# ----------------------------------------------------------------------


def local_gather_spec(sharding: Sharding, keep_local=("experts",)):
    """The spec a read gathers: the leaf's, with the dims named in
    ``keep_local`` (the expert dim, which the expert-parallel MoE reads
    locally) left split."""
    return tuple(None if n in keep_local else e
                 for e, n in zip(sharding.spec, sharding.names or
                                 (None,) * len(sharding.spec)))


@contextlib.contextmanager
def fsdp(leaves, shardings):
    """Register ``leaves`` (this rank's blocks) with their shardings: a
    read through :func:`gathered` gathers them."""
    prev = _ACTIVE["fsdp"]
    reg = dict(prev or {})
    for x, s in zip(leaves, shardings):
        reg[id(x)] = dataclasses.replace(s, spec=local_gather_spec(s))
    _ACTIVE["fsdp"] = reg
    try:
        yield
    finally:
        _ACTIVE["fsdp"] = prev


def gathered(a, rep: Optional[int] = None):
    """What the model reads of parameter leaf ``a`` (row ``rep`` of a
    stacked leaf when given): the full leaf, gathered
    (:func:`gather_leaf`), when ``a`` is registered with :func:`fsdp`;
    else ``a`` (``a[rep]``) itself."""
    reg = _ACTIVE["fsdp"]
    s = reg.get(id(a)) if reg else None
    if rep is not None:
        a = a[rep]
    if s is None:
        return a
    if rep is not None:
        if s.spec[0] is not None:
            raise ValueError(f"a stacked leaf split over its layers: "
                             f"{s.spec}")
        s = dataclasses.replace(s, spec=s.spec[1:], names=s.names[1:])
    return gather_leaf(a, s)


# ----------------------------------------------------------------------
# The batch, and reductions over it
# ----------------------------------------------------------------------


@contextlib.contextmanager
def batch_split(axes):
    """The enclosed calls run on this rank's rows of a batch split over
    ``axes``."""
    prev = _ACTIVE["batch_axes"]
    _ACTIVE["batch_axes"] = tuple(axes)
    try:
        yield
    finally:
        _ACTIVE["batch_axes"] = prev


def batch_axes() -> Tuple[str, ...]:
    """The axes the enclosing :func:`batch_split` split the batch over."""
    return _ACTIVE["batch_axes"]


def batch_replicas() -> int:
    """How many ranks of the (non-manual) mesh hold each row: the
    product of the axes the batch is not split over."""
    mesh = _ACTIVE["mesh"]
    return math.prod(mesh.sizes[a] for a in auto_axes(mesh)
                     if a not in _ACTIVE["batch_axes"])


def mesh_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every (non-manual) axis of the mesh (itself when
    every axis is manual: each pod of the compressed step on a mesh of
    pods alone); no gradient."""
    mesh = _ACTIVE["mesh"]
    out = t.detach().clone()
    axes = auto_axes(mesh)
    return all_reduce(out, mesh.group(axes)) if axes else out


class _MeshMean(torch.autograd.Function):
    """The mean over the mesh's ranks. Its backward is the local share
    (``g / n``): the caller's gradients are summed over the ranks
    afterwards (the train step's reduction), which completes the
    transpose of the mean."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = math.prod(mesh.sizes[a] for a in axes)
        ctx.n = n
        out = x.detach().clone()
        all_reduce(out, mesh.group(axes))
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def mesh_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over every (non-manual) axis of the active mesh."""
    mesh = _ACTIVE["mesh"]
    axes = auto_axes(mesh)
    return _MeshMean.apply(x, mesh, axes) if axes else x


class _AllToAll(torch.autograd.Function):
    """Block i of the result comes from group rank i's block ``rank``;
    the op is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        return all_to_all(torch.empty_like(x), x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return all_to_all(torch.empty_like(g), g, ctx.group), None


def all_to_all_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all of (G, ...) blocks, with a backward."""
    return _AllToAll.apply(x, group)


# ----------------------------------------------------------------------
# Tensor-parallel serving
# ----------------------------------------------------------------------


@contextlib.contextmanager
def tp_shard(group):
    """Run the enclosed model calls as one rank of ``group``."""
    prev = _ACTIVE["tp_group"]
    _ACTIVE["tp_group"] = group
    try:
        yield
    finally:
        _ACTIVE["tp_group"] = prev


def tp_axis() -> Optional[dist.ProcessGroup]:
    """The active tensor-parallel group, or None outside a TP call."""
    return _ACTIVE["tp_group"]


def tp_reduce(y: torch.Tensor) -> torch.Tensor:
    """Sum a K-partial matmul output over the active group, in place
    (no-op without one). It must run BEFORE any residual add: a
    residual folded into a partial shard's epilogue would be summed
    once per rank."""
    group = _ACTIVE["tp_group"]
    if group is None:
        return y
    y = y.contiguous()
    dist.all_reduce(y, group=group)
    tp_reduce.launches += 1
    tp_reduce.bytes += _nbytes(y)
    return y


def tp_gather(y: torch.Tensor) -> torch.Tensor:
    """Every rank's block of the last axis, concatenated in rank order
    (the tiled all-gather; no-op without an active group)."""
    group = _ACTIVE["tp_group"]
    if group is None:
        return y
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    tp_gather.launches += 1
    out = torch.cat(parts, dim=-1)
    tp_gather.bytes += _nbytes(out)
    return out


tp_reduce.launches = 0
tp_gather.launches = 0
reset_counts()
