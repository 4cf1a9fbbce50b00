"""Sharded npz checkpointer: atomic, async, in the JAX package's format.

The port's copy of the JAX package's ``checkpoint/checkpointer.py``,
written so that each package restores the other's checkpoints:

  * **Format** — the tree's leaves in npz shards of at most 512 MiB,
    each keyed by its path string (``core/tree.py``: ``.params/embed``,
    ``.opt/.step``, ``.opt/.mu/stages/0/stacked/0/attn/wqkv``) with
    ``/`` written as ``|``, and a ``manifest.json`` of the step, the
    caller's ``extra`` and each shard's keys and sha256.
  * **Atomicity** — writes go to ``step_<N>.tmp/`` then ``os.rename`` to
    ``step_<N>/``; a ``latest`` marker is updated last, so a crash
    mid-write never corrupts the latest good checkpoint.
  * **Async** — :class:`AsyncCheckpointer` copies the tree to host
    memory on the caller's thread and writes it on a background thread.
  * **Integrity** — :func:`restore` checks each shard's sha256 first.

  * **Sharded states** — ``save(..., shardings=)`` takes this rank's
    blocks of a state on a mesh (``partitioning.Sharding``), gathers
    each leaf in turn (every rank joins the collectives) and writes the
    global leaves from rank 0: the format of one device's checkpoint,
    which either package restores. ``restore(..., shardings=)`` gives
    each rank its block of every leaf for any mesh (elastic: the mesh
    may differ from the one that saved).

A bf16 leaf is saved as the JAX package saves it (``ml_dtypes``'
bfloat16, which that writer needs).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core import tree as tree_lib

_SHARD_BYTES = 512 * 1024 * 1024


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (a copy)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _host_tree(tree: Any, shardings: Optional[Any]) -> Any:
    """The tree's leaves on the host; with ``shardings`` the global
    leaves, each gathered from the ranks' blocks in turn (every rank
    takes part; only rank 0 keeps them: the others get None)."""
    if shardings is None:
        return tree_lib.tree_map(_host, tree)
    from repro_torch.core import partitioning as part
    keep = _rank() == 0

    def one(leaf, s):
        full = part.full_leaf(leaf, s)
        return _host(full) if keep else None
    return tree_lib.tree_map(one, tree, shardings)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None, shardings: Optional[Any] = None
         ) -> str:
    """Synchronous atomic save. Returns the final directory. With
    ``shardings`` every rank calls it with its blocks, rank 0 writes,
    and every rank returns once the checkpoint is written."""
    if shardings is not None:
        import torch.distributed as dist
        tree = _host_tree(tree, shardings)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if _rank() == 0:
            save(ckpt_dir, step, tree, extra)
        dist.barrier()
        return final
    flat = tree_lib.leaves_with_paths(tree)
    paths = [p for p, _ in flat]
    host = [_host(leaf) for _, leaf in flat]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    # chunk leaves into npz shards of bounded size
    shards, cur, cur_bytes = [], {}, 0
    for p, a in zip(paths, host):
        cur[p] = a
        cur_bytes += a.nbytes
        if cur_bytes >= _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if cur:
        shards.append(cur)

    manifest = {"step": step, "extra": extra or {}, "shards": []}
    for i, shard in enumerate(shards):
        fn = f"shard_{i:05d}.npz"
        fp = os.path.join(tmp, fn)
        np.savez(fp, **{k.replace("/", "|"): v for k, v in shard.items()})
        manifest["shards"].append({"file": fn, "keys": list(shard),
                                   "sha256": _sha256(fp)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return final


class AsyncCheckpointer:
    """Snapshot to host memory on the caller's thread, write on a
    background thread; keep the newest ``keep`` checkpoints. With
    ``shardings`` every rank gathers with the others on its own thread,
    and rank 0 alone writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None,
                   shardings: Optional[Any] = None):
        self.wait()
        snapshot = _host_tree(tree, shardings)
        if _rank() != 0:
            return

        def work():
            save(self.ckpt_dir, step, snapshot, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(all_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "latest")
    if os.path.exists(marker):
        with open(marker) as f:
            s = int(f.read().strip())
        if os.path.isdir(os.path.join(ckpt_dir, f"step_{s:08d}")):
            return s
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tensor(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=not a.flags.c_contiguous)  # 0-d stays
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like: Any, *, device="cuda",
            verify: bool = True, shardings: Optional[Any] = None):
    """Restore into the structure and dtypes of ``like``, each leaf on
    ``device``. With ``shardings`` (a tree of ``partitioning.Sharding``
    of ``like``'s structure, on any mesh) each leaf is this rank's block,
    cut on the host. Returns (tree, extra)."""
    device = runtime.resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {}
    for sh in manifest["shards"]:
        fp = os.path.join(d, sh["file"])
        if verify and _sha256(fp) != sh["sha256"]:
            raise IOError(f"checksum mismatch in {fp}")
        with np.load(fp) as z:
            for k in z.files:
                arrays[k.replace("|", "/")] = z[k]

    flat = tree_lib.leaves_with_paths(like)
    missing = [p for p, _ in flat if p not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    if shardings is None:
        restored = [_tensor(arrays[p], ref, device) for p, ref in flat]
    else:
        from repro_torch.core import partitioning as part
        restored = [part.shard_leaf(_tensor(arrays[p], ref, "cpu"), s).to(
            device) for (p, ref), s in zip(flat,
                                           tree_lib.leaves(shardings))]
    return tree_lib.unflatten(like, restored), manifest["extra"]
