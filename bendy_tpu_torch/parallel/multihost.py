"""Process-group bootstrap, the backend rule and the film gather.

Counterpart of ``bendy_tpu/parallel/multihost.py``. Every rank runs the
same program (one process per rank); the only traffic is the film
all-reduce over a tile's sample ranks, the ray-count all-reduce, and the
final gather of the row blocks to rank 0.

Usage on each rank (or under ``torchrun``, which sets the variables):

    from bendy_tpu_torch.parallel import initialize, make_mesh, film_to_host0
    initialize(coordinator="host0:1234", num_processes=N, process_id=i,
               device="cuda")
    mesh = make_mesh(tiles, samples, device="cuda")
    rows, rays = make_kernel_pass_sharded(...)(cam_packed, seed, 0)
    film = film_to_host0(rows, mesh)       # [H, W, 3] numpy on rank 0

**The backend rule**, the one place it is decided (:func:`choose_backend`):
``gloo`` for CPU tensors; ``nccl`` on CUDA, where every rank of a host
needs a card of its own (rank -> ``cuda:{local_rank}``); several ranks
sharing a card only when the caller passes ``backend="gloo"`` (gloo
all-reduces CUDA tensors; NCCL refuses two ranks on one card). With
``nccl`` and more ranks than cards it raises with both counts.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0  # every rendezvous and collective gives up after this


def free_port() -> int:
    """A free TCP port on this host's loopback."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_world_size(world_size: int) -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (set by torchrun), else all."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def local_rank(rank: int) -> int:
    """This rank's index on its host: ``LOCAL_RANK`` (torchrun), else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank))


def choose_backend(device_type: str, local_world: int, backend: Optional[str] = None) -> str:
    """The process-group backend for ranks rendering on ``device_type``
    ("cuda" or "cpu"), ``local_world`` of them on this host."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU tensors go through gloo, not {backend!r}")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"ranks render on cuda or cpu, not {device_type!r}")
    backend = backend or "nccl"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"nccl needs a card per rank: {local_world} ranks on this host, {cards} "
                "card(s); pass backend='gloo' to share cards")
    elif backend != "gloo":
        raise ValueError(f"backend is 'nccl' or 'gloo', not {backend!r}")
    return backend


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device a rank renders on: the CPU, or ``cuda:{local_rank}``
    (modulo the cards, when gloo ranks share them)."""
    from bendy_tpu_torch.utils.device import resolve_device

    if device_type == "cpu":
        return torch.device("cpu")
    dev = resolve_device("cuda")
    return torch.device(dev.type, local_rank(rank) % torch.cuda.device_count())


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device: str = "cuda") -> str:
    """``torch.distributed.init_process_group`` over ``tcp://coordinator``.

    Missing arguments come from the variables torchrun sets
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
    ``jax.distributed.initialize`` detects its own. ``device`` ("cuda" or
    "cpu") and ``backend`` pick the backend by :func:`choose_backend`;
    on CUDA the rank's card becomes the current device. Returns the
    backend.
    """
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator: pass one or set MASTER_ADDR and MASTER_PORT")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    backend = choose_backend(device, local_world_size(num_processes), backend)
    if device == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def film_to_host0(rows: torch.Tensor, mesh) -> Optional[np.ndarray]:
    """Gather a ('tiles',)-sharded film to rank 0 as one [H, W, 3] numpy
    array (None on the other ranks).

    After the pass every rank of a tile holds that tile's rows; the first
    sample rank of each tile sends them, so H·W·3·4 bytes move in all. The
    sends go through host tensors in a gloo group (gloo does not gather
    CUDA tensors)."""
    host = rows.detach().to("cpu", torch.float32).contiguous()
    if mesh.world == 1:
        return host.numpy()
    if mesh.rank == 0:
        blocks = [host]
        for ti in range(1, mesh.tiles):
            buf = torch.empty_like(host)
            dist.recv(buf, src=ti * mesh.samples, group=mesh.host_group)
            blocks.append(buf)
        return torch.cat(blocks, dim=0).numpy()
    if mesh.si == 0:
        dist.send(host, dst=0, group=mesh.host_group)
    return None
