"""The shard layout of the sharded paths: which shards exist and where
each lives.

The reference's only parallelism is ``grankMulti``'s thread data
parallelism over node ranges (header-only/grankMulti.h:289-436).  Here a
1-D :class:`Mesh` of ``n_shards`` shards splits the node range: shard ``p``
owns rows ``[p*S, (p+1)*S)`` of the ``[N, L]`` baskets.  A shard is a
``torch.device``; one device may hold several shards (virtual shards: four
shards on one card, or on the CPU, run the same program as four cards).

A process holds its own shards.  In a run of several processes
(:func:`init_distributed`) the mesh spans them all, every process holds the
same number of shards, and the shards of process ``r`` are the global
indices ``r*k .. r*k+k-1``; the ring's rotation crosses a process boundary
through ``torch.distributed`` point-to-point copies (parallel/ring.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards in all; ``shards`` are this process's, as
    (global shard index, device) pairs in index order; ``group`` is the
    ``torch.distributed`` process group of a multi-process mesh (None: one
    process holds every shard)."""

    n_shards: int
    shards: Tuple[Tuple[int, torch.device], ...]
    group: Any = None

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(dev for _, dev in self.shards)

    def row_range(self, num_rows: int) -> Tuple[int, int]:
        """The global rows ``[start, stop)`` this process's shards own."""
        s = shard_size(num_rows, self.n_shards)
        first, last = self.shards[0][0], self.shards[-1][0]
        return min(first * s, num_rows), min((last + 1) * s, num_rows)


def shard_size(n: int, d: int) -> int:
    """Rows a shard owns: ``ceil(n / d)``, at least 1."""
    return max(1, -(-n // d))


def _distributed():
    """The default process group, or None outside a multi-process run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _local_default_devices(group) -> list:
    """The devices a process holds by default: in a multi-process run its
    one device (the current card under NCCL, the CPU under gloo), else
    every card."""
    if group is not None:
        import torch.distributed as dist

        if dist.get_backend(group) == "nccl":
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cpu")]
    resolve_device("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_shards: int | None = None, devices: Sequence | None = None) -> Mesh:
    """A mesh over the first ``n_shards`` of ``devices`` (default: every
    card; in a multi-process run, this process's device).  ``devices`` may
    repeat a device: ``[torch.device("cpu")] * 4`` is four shards on the
    CPU.  In a multi-process run ``devices`` are this process's, and the
    mesh spans ``world_size * len(devices)`` shards."""
    group = _distributed()
    devices = [torch.device(d) for d in (
        devices if devices is not None else _local_default_devices(group))]
    for d in devices:
        if d.type == "cuda" and d.index is None:
            raise ValueError("a CUDA shard device needs an index, e.g. cuda:0")
        resolve_device(d)
    if group is None:
        if n_shards is not None:
            if n_shards > len(devices):
                raise ValueError(
                    f"n_shards={n_shards} exceeds available devices ({len(devices)})"
                )
            devices = devices[:n_shards]
        return Mesh(len(devices), tuple(enumerate(devices)))
    import torch.distributed as dist

    world, rank, k = dist.get_world_size(group), dist.get_rank(group), len(devices)
    total = world * k
    if n_shards is not None and n_shards > total:
        raise ValueError(f"n_shards={n_shards} exceeds available devices ({total})")
    if n_shards is not None and n_shards != total:
        raise ValueError(
            f"a multi-process mesh spans every process's shards ({total}), "
            f"got n_shards={n_shards}"
        )
    return Mesh(total, tuple((rank * k + i, d) for i, d in enumerate(devices)), group)


def mesh_for(n_shards: int, devices: Sequence | None = None, device=None) -> Mesh:
    """The mesh of the ``*_multi`` entry points: ``n_shards`` shards over
    ``devices``; without them, over the cards, or ``n_shards`` shards on
    the CPU when ``device`` is the CPU."""
    if devices is None and resolve_device(device).type == "cpu":
        devices = [torch.device("cpu")] * n_shards
    return make_mesh(n_shards, devices)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join a multi-process run: after it, :func:`make_mesh` spans every
    process's shards.

    ``coordinator_address`` is ``host:port`` of process 0 (every process
    passes the same); without it the run is described by the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``backend`` defaults to NCCL when a card is present, gloo on the CPU;
    under NCCL process ``r`` takes card ``r mod device_count``.
    """
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id,
    )


def put_sharded(arr: np.ndarray, mesh: Mesh) -> list:
    """This process's shards of a host array split evenly by rows (its row
    count a multiple of ``n_shards``): one tensor a shard, on its device."""
    s = arr.shape[0] // mesh.n_shards
    return [torch.as_tensor(arr[p * s : (p + 1) * s]).to(dev) for p, dev in mesh.shards]
