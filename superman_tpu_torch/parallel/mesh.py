"""Device meshes and the multi-process runtime.

Port of ``superman_tpu/parallel/mesh.py``.  A mesh is a list of torch
devices, one entry per shard of a walk, each card entry with a stream of
its own (several entries may name one card: four streams of cuda:0 drive
the multi-device code on one H100, and several "cpu" entries drive it in
the tests, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``).  Processes join through
``torch.distributed`` (gloo) when torchrun's variables say there is more
than one; they exchange one host total each (parallel/multihost.py).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh(list):
    """A list of torch.devices, one per shard, with `streams[i]` the
    stream of entry i where it is a card (None on the CPU)."""

    def __init__(self, devices: Sequence):
        super().__init__(torch.device(d) for d in devices)
        if not len(self):
            raise ValueError("a mesh needs at least one device")
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self]

    def on(self, i: int):
        """Context that runs the work of entry i on its stream."""
        s = self.streams[i]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def synchronize(self) -> None:
        for s in self.streams:
            if s is not None:
                s.synchronize()


def init_distributed() -> None:
    """Join the process group when torchrun's WORLD_SIZE > 1 is set
    (gloo, for the host totals; RANK, MASTER_ADDR and MASTER_PORT from the
    same environment); a no-op otherwise or when already joined.  Call
    once at program start in each process."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    dist.init_process_group("gloo", world_size=world,
                            rank=int(os.environ["RANK"]))


def process_info() -> tuple:
    """(index, count) of this process in the joined group, (0, 1) when
    none was joined."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over `devices` (default: every visible card, cuda:0 ..),
    the first `num_devices` of them when that is given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if num_devices is not None:
        if len(devs) < num_devices:
            raise RuntimeError(f"requested a {num_devices}-device mesh but "
                               f"only {len(devs)} devices are given")
        devs = devs[:num_devices]
    return Mesh(devs)


def _available(device: torch.device, want: int) -> int:
    """Entries a mesh can have on `device`'s kind: the visible cards, or on
    the CPU as many as are asked for."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return max(1, want)


def mesh_for_flags(flags, device: torch.device) -> Optional[Mesh]:
    """None (one device) unless the flags ask for a multi-device run: a
    mesh_shape of more than one, or a multi-device algorithm id
    (core/flags.id_behavior), which asks for flags.gpu_num entries (all
    cards for gpu_num <= 0; on the CPU, all means one).  The mesh has
    min(want, available) entries, so with fewer cards than asked for the
    run uses what there is, and on one card it runs on one device."""
    device = torch.device(device)

    def mesh_of(want: int) -> Optional[Mesh]:
        k = min(want, _available(device, want))
        if k <= 1:
            return None
        if device.type == "cuda":
            return make_mesh(k)
        return make_mesh(devices=[device] * k)

    if flags.mesh_shape is not None:
        return mesh_of(int(np.prod(flags.mesh_shape)))
    from ..core.flags import id_behavior
    try:
        multi = id_behavior(flags.perman_algo, flags.sparse,
                            flags.approximation)["multi"]
    except ValueError:
        multi = False     # unknown ids are rejected by the dispatcher
    if not multi:
        return None
    if flags.gpu_num > 0:
        return mesh_of(int(flags.gpu_num))
    return mesh_of(_available(device, 1))
