"""Devices and processes (counterpart of
``centroids_reid_tpu/parallel/mesh.py``).

The gallery mesh: the devices of one process that a gallery is sharded
over. The JAX package builds a one-axis ``jax.sharding.Mesh`` over
``jax.devices()`` and shards gallery rows over its ``gallery`` axis. Here a
``Mesh`` is the ordered tuple of ``torch.device`` s along that axis: shard
``s`` lives on ``devices[s]``, and the mesh's first device holds the
queries and the merged results. A device may appear more than once, so
that several shards share one card (or the CPU): the sharded program then
runs whole on one device, as the JAX tests run it on a virtual 8-device CPU
mesh.

The processes: data-parallel training and evaluation over a
``torch.distributed`` process group, one process per card (NCCL; gloo on
the CPU), launched by ``torchrun``. The JAX package's ``make_data_mesh`` /
``group_sharded`` / ``shard_batch`` place the global batch's group axis
over the devices of every process; with one card per process the rank is
the group shard, so they have no counterpart: each rank assembles its
groups of the global plan (``local_groups``) and the step all-reduces
(``all_reduce_``). ``replicate`` broadcasts rank 0's tensors, where the
JAX package relies on identical seeding. Without a process group every
helper here is the one-process identity: one process, rank 0, no
collective.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

GALLERY_AXIS = "gallery"


class Mesh:
    """An ordered, non-empty tuple of devices along ``GALLERY_AXIS``.
    ``shape[GALLERY_AXIS]`` is the number of shards, as in JAX."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {GALLERY_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def local_devices(device="cuda") -> List[torch.device]:
    """The devices of ``device``'s type that this process sees: every
    visible card for a CUDA device, else that device once."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_retrieval_mesh(num_devices: Optional[int] = None,
                        devices: Optional[Sequence] = None) -> Mesh:
    """A gallery mesh over the first ``num_devices`` of ``devices`` (by
    default every visible card, as the JAX version takes
    ``jax.devices()``). ``devices`` may repeat a device."""
    devices = local_devices("cuda") if devices is None else list(devices)
    if not devices:
        raise ValueError("no card visible: pass devices=[...]")
    n = num_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from {len(devices)}")
    return Mesh(devices[:n])


def on_device(device: torch.device):
    """Make ``device`` current while the block runs: the kernels launch on
    the current card's stream. A no-op off CUDA."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_width(rows: int, shards: int, unit: int = 1) -> int:
    """Rows per shard when ``rows`` rows are padded to a multiple of
    ``unit * shards`` and cut ``shards`` ways (at least ``unit``)."""
    return max(1, -(-rows // (unit * shards))) * unit


def split_rows(x: torch.Tensor, mesh: Mesh, width: int,
               fill=0) -> List[torch.Tensor]:
    """Shard ``x [N, ...]`` (N <= ``width`` x shards) over ``mesh``: shard
    ``s`` holds rows ``s * width .. (s + 1) * width`` on ``devices[s]``,
    short shards padded with ``fill``. A shard that needs no padding on
    the device ``x`` is on is a view of ``x``."""
    if x.shape[0] > width * len(mesh.devices):
        raise ValueError(f"{x.shape[0]} rows do not fit {len(mesh.devices)} "
                         f"shards of {width}")
    out = []
    for s, dev in enumerate(mesh.devices):
        part = x[s * width:(s + 1) * width]
        short = width - part.shape[0]
        if short:
            part = torch.cat([part, part.new_full((short, *x.shape[1:]),
                                                  fill)])
        out.append(part.to(dev).contiguous())
    return out


# --------------------------------------------------------------------------
# processes


def distributed() -> bool:
    """Whether this process belongs to a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The group's world size; 1 without a process group."""
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if distributed() else 0


def process_device(device="cuda") -> torch.device:
    """The device a process computes and communicates on: ``cuda:LOCAL_RANK``
    under NCCL, the CPU under gloo, ``device`` without a process group."""
    if not distributed():
        return torch.device(device)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def barrier() -> None:
    """Every process waits here for the others (the JAX package's
    ``sync_global_devices``). A no-op without a process group."""
    if not distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[process_device().index])
    else:
        dist.barrier()


def local_groups(num_groups: int) -> Tuple[int, int]:
    """(group_offset, local_groups): this rank's contiguous share of the
    global plan's ``num_groups`` groups. ``ValueError`` when they do not
    split evenly over the processes (the JAX package divides without a
    check; ROADMAP.md queue 3)."""
    n = process_count()
    if num_groups % n:
        raise ValueError(f"{num_groups} training groups (TPU.NUM_GROUPS) do "
                         f"not split evenly over {n} processes")
    per = num_groups // n
    return process_index() * per, per


def _memory_view(t: torch.Tensor) -> Optional[torch.Tensor]:
    """A 1-D view of ``t``'s elements in memory order when they fill their
    span of storage (a contiguous or channels_last tensor), else None."""
    if t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(
            memory_format=torch.channels_last)):
        return t.detach().as_strided((t.numel(),), (1,))
    return None


def _collective_(tensors: Sequence[torch.Tensor], collective,
                 mean_from: Optional[int] = None) -> None:
    """Per dtype: ``tensors`` (on any device) packed into one flat buffer on
    the process's device, ``collective(buffer)``, the buffer copied back.
    With ``mean_from`` the tensors from that index on are divided by the
    process count in the buffer first. Each tensor is packed in memory
    order (a channels_last gradient needs no reordering copy; every
    process packs its tensors alike, so the collective pairs the same
    elements) and the copies back run as one multi-tensor copy, not one
    launch a tensor."""
    dev = process_device()
    n_proc = process_count()
    for dt in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        views = [_memory_view(tensors[i]) for i in idx]
        flat = torch.cat([(v if v is not None else tensors[i].reshape(-1))
                          .detach().to(dev) for i, v in zip(idx, views)])
        if mean_from is not None:
            summed = sum(tensors[i].numel() for i in idx if i < mean_from)
            flat[summed:].div_(n_proc)
        collective(flat)
        parts = flat.split([tensors[i].numel() for i in idx])
        fast = [(v, part) for v, part in zip(views, parts)
                if v is not None and v.device == dev]
        with torch.no_grad():
            if fast:
                torch._foreach_copy_([v for v, _ in fast],
                                     [part for _, part in fast])
            for i, v, part in zip(idx, views, parts):
                if v is None or v.device != dev:
                    tensors[i].copy_(part.view(tensors[i].shape))


def replicate(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` (parameters, buffers, centers, optimizer
    state; on any device) with process ``src``'s values: one broadcast of
    a flat buffer per dtype. A no-op without a process group."""
    if not distributed():
        return
    _collective_([t for t in tensors if t is not None],
                 lambda flat: dist.broadcast(flat, src))


def all_reduce_(sums: Sequence[torch.Tensor],
                means: Sequence[torch.Tensor]) -> None:
    """In place: each tensor of ``sums`` becomes its sum over the
    processes, each of ``means`` its mean (divided by the process count
    before the sum), by one ``all_reduce(SUM)`` over one flat buffer per
    dtype (one in all when they share a dtype). A no-op without a process
    group."""
    if not distributed():
        return
    _collective_(list(sums) + list(means), dist.all_reduce,
                 mean_from=len(sums))


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is set on any process: an ``all_reduce(MAX)`` of
    an int tensor on the process's device (NCCL takes only card tensors).
    The local flag without a process group."""
    if not distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=process_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def process_allgather(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` ([N_r, ...], N_r may differ) concatenated in
    rank order, on ``x``'s device: the row counts are gathered first, each
    ``x`` padded to the largest for the ``all_gather`` and cut back after.
    ``x`` itself without a process group."""
    if not distributed():
        return x
    dev = process_device()
    n = process_count()
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(rows) for _ in range(n)]
    dist.all_gather(counts, rows)
    counts = [int(c.item()) for c in counts]
    per = max(counts)
    local = x.to(dev)
    if per > x.shape[0]:
        local = torch.cat([local, local.new_zeros((per - x.shape[0],
                                                   *x.shape[1:]))])
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(x.device)
