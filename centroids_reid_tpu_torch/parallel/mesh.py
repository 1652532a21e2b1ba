"""The gallery mesh: the devices of one process that a gallery is sharded
over (counterpart of the retrieval half of
``centroids_reid_tpu/parallel/mesh.py``).

The JAX package builds a one-axis ``jax.sharding.Mesh`` over
``jax.devices()`` and shards gallery rows over its ``gallery`` axis. Here a
``Mesh`` is the ordered tuple of ``torch.device`` s along that axis: shard
``s`` lives on ``devices[s]``, and the mesh's first device holds the
queries and the merged results. A device may appear more than once, so
that several shards share one card (or the CPU): the sharded program then
runs whole on one device, as the JAX tests run it on a virtual 8-device CPU
mesh.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

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
