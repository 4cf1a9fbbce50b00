"""The general harness: one cell of ``BENCHMARK.json``, found by name and
run once.

A run: import the port and load its kernels (built into the checkout's
``build/`` by the first run), make the weights on the device from the
seed, let the port build its state from them, warm up the cell's own
shapes, measure for the window, read the device's peak memory, read
the per-layer metrics of a traced run, free the port's state, make the
weights again from the seed, hold what the window produced against the
plain reference, and last check that nothing of JAX or the JAX package
was loaded. Nothing here branches on a cell: the traffic file names its
loop (``drivers/<driver>.py``), the configuration file its model's
adapter (``port/<model>.py``), and the plain reference, the work and
the limits are found by the configuration's and the cell's names.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded once the window closed:
# JAX, its companions and the JAX package (compared whole, so the port,
# ``repro_torch``, is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class HarnessError(RuntimeError):
    """A run that cannot give a result."""


def derive_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one purpose (``tags``) of the run's ``--seed``:
    any whole number, negative or past 64 bits."""
    words = [int(seed) % (1 << 64)] + [zlib.crc32(t.encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, *map(str, tags)))


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(path: Path) -> ModuleType:
    """A plug-in file as a module of its own (metric files carry dots in
    their names, so they are loaded by path)."""
    path = Path(path)
    if not path.exists():
        raise HarnessError(f"no file {path}")
    name = "perfbench_plugin_" + "_".join(
        path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Cell:
    """Everything one cell needs, found by name."""
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    reference: ModuleType
    work: ModuleType
    port: ModuleType
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def resolve(name: str, root: Path = ROOT, config: Optional[dict] = None,
            traffic: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files.
    ``config`` / ``traffic`` replace the files' contents (the CPU tests
    run a cell's code at a small size)."""
    manifest_path = root / "BENCHMARK.json"
    if not manifest_path.exists():
        raise HarnessError(f"no {manifest_path}")
    manifest = load_json(manifest_path)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise HarnessError(
            f"no workload {name!r}; known: "
            f"{[w['name'] for w in manifest['workloads']]}")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    config = config if config is not None else load_json(
        root / cfg_entry["file"])
    traffic = traffic if traffic is not None else load_json(
        HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_path)["limits"]

    def applies(metric) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    readers = {m["name"]: load_module(
        HERE / "metrics" / f"{m['name']}.py").read for m in per_layer}
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        traffic=traffic,
        driver=load_module(HERE / "drivers" / f"{traffic['driver']}.py"),
        reference=load_module(HERE / "reference" / f"{entry['config']}.py"),
        work=load_module(HERE / "work" / f"{entry['config']}.py"),
        port=load_module(HERE / "port" / f"{config['model']}.py"),
        limits=limits, end_to_end=e2e, per_layer=per_layer, readers=readers)


@dataclass
class Window:
    """What a driver's measured window gives back."""
    seconds: float                      # first submission to last answer
    units: List[dict]                   # the work of each unit completed
    attempted: int
    failed: int
    e2e: Dict[str, float]
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Env:
    """What a driver is built from."""
    config: dict
    traffic: dict
    system: Any
    seed: int
    device: Any
    reference: ModuleType


@dataclass
class ReaderContext:
    """What a per-layer metric's reader reads."""
    window: Window
    traced_units: List[dict]
    trace: Any                          # trace.Summary
    work: ModuleType
    config: dict
    peak: Optional[dict]                # peaks.json's row for the card


def card_peak(kind: str) -> Optional[dict]:
    return load_json(HERE / "peaks.json")["cards"].get(kind)


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s power limit of the card (read, never set)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def free_memory(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def prepare(cell: Cell, seed: int, device):
    """Set-up: the weights from the seed, the port's state built from
    them, the cell's loop with its shapes warmed up. The harness keeps
    no copy of the weights: the port holds what it built."""
    import torch
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dtype = getattr(torch, cell.config["dtype"])
    weights = cell.reference.make_weights(cell.config, seed, device, dtype)
    system = cell.port.build(cell.config, weights, device)
    del weights
    free_memory(device)
    driver = cell.driver.Driver(Env(cell.config, cell.traffic, system,
                                    seed, device, cell.reference))
    driver.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return driver


def judge(cell: Cell, driver, seed: int, device, control: bool = False):
    """Free the port's state, make the weights again from the seed and
    hold what the window produced against the plain reference: the
    check's numbers (with ``control``, the control's numbers too, under
    ``control.<name>``) and the seconds the check took."""
    import torch
    driver.release()
    free_memory(device)
    weights = cell.reference.make_weights(
        cell.config, seed, device, getattr(torch, cell.config["dtype"]))
    t0 = time.perf_counter()
    numbers = dict(driver.check(cell.reference, weights))
    check_s = time.perf_counter() - t0
    if control:
        numbers.update({f"control.{k}": v for k, v in
                        driver.control(cell.reference, weights).items()})
    del weights
    free_memory(device)
    return numbers, check_s


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result's object.
    ``t_start`` is the process's start on the host clock."""
    import torch
    from perfbench import trace as trace_mod

    cuda = device.type == "cuda"
    driver = prepare(cell, seed, device)
    tcfg = cell.traffic.get("trace", {})
    tracer = trace_mod.Tracer(trace, tcfg.get("skip_units", 0),
                              tcfg.get("units", 0), device)
    tracer.warm()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    window = driver.window(seconds, tracer)
    tracer.finish()
    t_read = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
        peak_bytes = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak_bytes, kind = 0, "cpu"
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else device.type, "kind": kind,
        "count": cell.chips, "memory_peak_bytes": peak_bytes}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        if tracer.events is None:
            raise HarnessError(
                f"the window ended before unit {tracer.first}: nothing "
                "was traced")
        summary = trace_mod.summarize(
            tracer.events, trace_mod.load_families(HERE / "families"))
        traced = [window.units[i] for i in tracer.traced
                  if i < len(window.units)]
        ctx = ReaderContext(window, traced, summary, cell.work,
                            cell.config, card_peak(kind))
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        breakdown = summary.breakdown()
        print(f"trace: {len(tracer.events)} events, stopped in "
              f"{tracer.stop_s:.1f} s, read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] in window.e2e:
                value = window.e2e[m["name"]]
            else:
                raise HarnessError(f"the {cell.traffic['driver']} loop "
                                   f"gives no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if cuda:
        device_info["power_limit"] = power_limit()
    numbers, check_s = judge(cell, driver, seed, device)
    checks = {}
    for name, limit in cell.limits.items():
        if name not in numbers:
            raise HarnessError(f"the check gives no {name}")
        checks[name] = {"value": float(numbers[name]),
                        "limit": float(limit)}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    # last, after the readers, the release and the check: whatever any
    # of them loaded is in sys.modules now
    found = forbidden_modules()
    if found:
        raise HarnessError("modules of JAX or the JAX package are loaded: "
                           + ", ".join(found))
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(window.attempted),
        "failed": int(window.failed), "metrics": metrics,
        "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"seconds": window.seconds, "units": len(window.units),
                        "check_s": check_s}
    result["checks"] = checks
    return result


def check_lines(result: dict) -> List[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]
