"""What every driver of the benchmark shares: the cell as the driver sees
it, the port's config, seeds, the device check, the import guard and the
result line."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# top-level module names that no run may hold once its window has closed:
# JAX, its libraries and the JAX package the port was made from
BLOCKED = ("jax", "jaxlib", "flax", "centroids_reid_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


@dataclasses.dataclass
class Cell:
    """One run of one cell: the entries of ``BENCHMARK.json`` and the data
    files they name, with the run's arguments."""

    name: str
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # traffic/<traffic>.json
    limits: Dict[str, Any]        # limits/<workload>.json
    chips: int
    seed: int
    seconds: float
    trace: bool
    t0: float                     # perf_counter at process start
    device: str = "cuda"
    scratch: str = ""             # a directory this run may write into


@dataclasses.dataclass
class Check:
    """One number compared against its limit; ``ok`` is value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    end_to_end: Dict[str, float]
    observed: Dict[str, Any]      # what the per-layer readers read
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def port_cfg(config: dict, role: str):
    """The port's config for ``role`` (a key of the configuration's
    ``opts``): its defaults, then the recipe's options as the CLI would
    merge them."""
    from centroids_reid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list([str(v) for v in config["opts"][role]])
    return cfg


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (``tags`` name the use):
    any whole number, however large, gives independent streams."""
    words = [int(seed) % 2**64] + [
        int.from_bytes(str(t).encode(), "little") % 2**64 for t in tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def require_cards(chips: int) -> None:
    """Raise ``NoCard`` unless torch sees at least ``chips`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees "
                     f"{torch.cuda.device_count()}")


def blocked_modules(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of ``BLOCKED``, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(n for n in mods if n.split(".", 1)[0] in BLOCKED)


def gpu_kind(device: str = "cuda") -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def result_line(cell: Cell, out: Outcome, metrics: Dict[str, tuple],
                device_count: int) -> str:
    """The contract's JSON line: ``metrics`` maps a name to (value,
    unit); the checks come last, each number beside its limit."""
    platform = "gpu" if cell.device == "cuda" else "cpu"
    device = {"platform": platform, "kind": gpu_kind(cell.device),
              "count": device_count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cell.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed),
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in metrics.items()},
            "device": device}
    if cell.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return json.dumps(line, allow_nan=True)


def check_lines(checks: Sequence[Check]) -> List[str]:
    return [f"check {c.name}: {c.value!r} against the limit {c.limit!r} "
            f"-> {'ok' if c.ok else 'FAILED'}" for c in checks]


def log(cell: Cell, msg: str) -> None:
    import time

    print(f"[{time.perf_counter() - cell.t0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def cache_dirs(root: str) -> Dict[str, str]:
    """Fixed cache directories inside the checkout, for the libraries that
    compile on first use; set before they are imported."""
    base = os.path.join(root, ".bench_cache")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": os.path.join(base, "inductor"),
            "CUDA_CACHE_PATH": os.path.join(base, "nv")}
