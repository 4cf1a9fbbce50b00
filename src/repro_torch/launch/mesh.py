"""Meshes over a ``torch.distributed`` world, the JAX package's
``launch/mesh.py``.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
data=16, model=16) = 512 ranks; ``pod`` is the slow cross-pod link that
gradient compression targets. The host mesh (2, 2, 2) is the tests' and
the train CLI's ``--mesh host``.

Functions, not module state: importing this module touches no device
and no process group. Each builds a :class:`partitioning.Mesh` over the
initialised default group, and every rank must call it; a world of the
wrong size raises.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from repro_torch.core.partitioning import Mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"),
                   device_type=None) -> Mesh:
    """A small mesh for the tests and the train CLI's ``--mesh host``."""
    return Mesh(shape, axes, device_type)


def describe(mesh) -> str:
    return mesh.describe()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv, n: int, timeout_s: float,
                what: str) -> list:
    """Run ``python -m module`` once per rank with ``argv`` plus ``--rank
    i`` and a shared ``--dist-init`` (a ``tcp://localhost`` port picked
    here unless given); every rank must exit 0 within ``timeout_s``, and
    a rank that fails stops the others. Returns each rank's standard
    output."""
    if "--dist-init" not in argv:
        argv = [*argv, "--dist-init", f"tcp://localhost:{free_port()}"]
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(n)]
    outs = [("", "")] * n

    def drain(i):
        outs[i] = procs[i].communicate()
    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + timeout_s
    # a rank that fails stops the others at once: they would wait in
    # their next collective until its timeout
    while (time.monotonic() < deadline
           and any(p.poll() is None for p in procs)
           and not any(p.poll() for p in procs)):
        time.sleep(0.2)
    failed = []
    for i, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            failed.append(f"rank {i} was stopped after {timeout_s:.0f} s "
                          "or another rank's failure")
    for th in threads:
        th.join()
    for i, p in enumerate(procs):
        if p.returncode:
            failed.append(f"rank {i} exited {p.returncode}:\n"
                          + outs[i][1][-4000:])
    if failed:
        raise RuntimeError(f"{what} failed: " + "\n".join(failed))
    return [out for out, _ in outs]
