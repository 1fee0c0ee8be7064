"""Multi-host initialization: one process per host, joined with
``torch.distributed``.

Counterpart of ``kobato_eyes_tpu/parallel/distributed.py``: each host runs
one process, :func:`initialize_cluster` joins the cluster
(``torch.distributed.init_process_group``, ``nccl`` over CUDA and ``gloo``
on the CPU, rendezvous at ``tcp://<coordinator>``), and :func:`global_mesh`
lays a (data, model) mesh over every process's devices, process-major with
``model`` innermost, so tensor-parallel traffic stays inside a host and only
data-parallel reductions cross hosts.

Nothing tells a program of its cluster, so the coordinator's address, the
process count and this process's index come from the arguments or the
environment. Tested on one box by spawning two processes joined over gloo
(``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import torch

from kobato_eyes_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices

logger = logging.getLogger(__name__)


def initialize_cluster(
    coordinator_address: str | None = None,
    *,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the multi-host cluster (env-driven when args are None).

    Env fallbacks: KET_COORDINATOR (``host:port``), KET_NUM_PROCESSES,
    KET_PROCESS_ID. ``backend`` defaults to ``nccl`` when a CUDA card is
    visible, ``gloo`` otherwise.
    """
    coordinator_address = coordinator_address or os.environ.get("KET_COORDINATOR")
    if num_processes is None and "KET_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KET_NUM_PROCESSES"])
    if process_id is None and "KET_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KET_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_cluster needs the coordinator address, the process count and this "
            "process's index (arguments or KET_COORDINATOR / KET_NUM_PROCESSES / KET_PROCESS_ID)"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    logger.info(
        "joined cluster: process %d/%d over %s",
        torch.distributed.get_rank(), torch.distributed.get_world_size(), backend,
    )


def _local_devices() -> list[torch.device]:
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return visible_devices(kind)


def global_mesh(*, model_parallel: int = 1, local_devices: Sequence | None = None) -> Mesh:
    """(data, model) mesh over every device in the cluster.

    ``local_devices``: this process's devices (default: its visible cards,
    or its one CPU); every process must give the same count. Outside a
    cluster the mesh is this process's alone. ``model_parallel`` should
    divide the per-process device count so tensor traffic never leaves a
    host. The entries of other processes carry their process index
    (``Mesh.process_ids``).
    """
    local = [torch.device(d) for d in (local_devices if local_devices is not None else _local_devices())]
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if model_parallel > len(local):
        logger.warning(
            "model_parallel=%d exceeds local devices (%d): tensor collectives "
            "will cross DCN", model_parallel, len(local),
        )
    if world == 1:
        return make_mesh(data=len(local) // max(model_parallel, 1), model=model_parallel, devices=local)
    gathered: list = [None] * world
    dist.all_gather_object(gathered, [str(d) for d in local])
    if len({len(g) for g in gathered}) != 1:
        raise ValueError(f"processes hold different device counts: {[len(g) for g in gathered]}")
    devices = [d for g in gathered for d in g]
    owners = [rank for rank, g in enumerate(gathered) for _ in g]
    layout = make_mesh(data=len(devices) // max(model_parallel, 1), model=model_parallel, devices=devices)
    ids = [owners[r * model_parallel : (r + 1) * model_parallel] for r in range(layout.shape["data"])]
    return Mesh(layout.devices.tolist(), process_ids=ids)
