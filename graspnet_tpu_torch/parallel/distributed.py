"""Multi-process runtime: torch.distributed for data-parallel training.

Counterpart of `graspnet_tpu/parallel/distributed.py`.  The JAX package
runs one process a host and lets XLA route the all-reduces; here one
process drives one device, and the ranks form a torch.distributed process
group over which the Trainer reduces batch-norm statistics, loss
denominators and gradients (`train/trainer.py`).

Launches (`apps/train.py`):

    python -m graspnet_tpu_torch.apps.train --n_devices 4 ...   # spawns 4 ranks
    torchrun --nproc_per_node 4 -m graspnet_tpu_torch.apps.train ...
    GRASPNET_COORDINATOR=host0:8476 GRASPNET_NUM_PROCESSES=2 \\
        GRASPNET_PROCESS_ID=$i python -m graspnet_tpu_torch.apps.train ...

Hybrid data x candidate training (`--candidate_devices C`) lays the
world out as D x C ranks: rank r is data row r // C, which loads that row's
scenes, and seed block r % C of their stage 2 (`hybrid_layout`,
`seed_block`, `column_group`).

The backend is NCCL for CUDA and gloo for the CPU unless the caller names
one.  Nothing falls back on its own: ranks that share a card (NCCL takes
one rank a device) need gloo named explicitly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from graspnet_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Join the default process group from the arguments, or from
    GRASPNET_COORDINATOR / NUM_PROCESSES / PROCESS_ID, or from torchrun's
    MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE.  Returns True when a
    multi-process runtime is up, False for a plain single process.  Safe to
    call more than once.  `backend`: 'nccl' or 'gloo'; by default NCCL when
    `device` is CUDA and gloo on the CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("GRASPNET_COORDINATOR")
    if num_processes is None and "GRASPNET_NUM_PROCESSES" in env:
        num_processes = int(env["GRASPNET_NUM_PROCESSES"])
    if process_id is None and "GRASPNET_PROCESS_ID" in env:
        process_id = int(env["GRASPNET_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            return False  # a plain single process
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process launch needs the coordinator address, the process count and this "
                         "process's id (GRASPNET_COORDINATOR, GRASPNET_NUM_PROCESSES, GRASPNET_PROCESS_ID)")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    return True


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK, else the global rank: one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device: str = "cuda") -> torch.device:
    """The device this rank drives: cuda:(local rank), or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank())


def global_mesh(axis_names: Sequence[str] = ("data",), shape=None, device: str = "cuda") -> Mesh:
    """Mesh of every rank's device in rank order (each rank drives the
    entry at its rank), or of the local cards in a single process."""
    if not dist.is_initialized():
        return make_mesh(None, axis_names, shape=shape)
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device(device)))
    return make_mesh(None, axis_names, devices=names, shape=shape)


def process_local_batch_slice(global_batch_size: int, candidate: int = 1) -> slice:
    """The [start, stop) rows of the global batch this rank should load:
    its data row's share (every rank of a row loads the same scenes)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    rows, row = n // candidate, hybrid_layout(i, candidate)[0]
    per = global_batch_size // rows
    assert per * rows == global_batch_size, f"data width {rows} must divide the global batch {global_batch_size}"
    return slice(row * per, (row + 1) * per)


def hybrid_layout(rank: int, candidate: int) -> tuple:
    """(data row, seed block) of a rank in a D x C world."""
    return divmod(rank, candidate)


def seed_block(block: int, candidate: int, num_seed: int) -> slice:
    """The seeds of block `block` of `candidate`: a contiguous 1/C."""
    if num_seed % candidate:
        raise ValueError(f"num_seed {num_seed} must divide by the candidate axis size {candidate}")
    per = num_seed // candidate
    return slice(block * per, (block + 1) * per)


def column_group(group, candidate: int):
    """The process group of this rank's seed-block column: one rank of each
    data row, so its ranks hold every scene of the global batch once.  A
    collective: every rank of the default group builds every column's
    group, in the same order (`torch.distributed.new_group`).  None when
    the world is one data row (the rank holds the whole batch)."""
    world = dist.get_world_size(group)
    rows = world // candidate
    if rows == 1:
        return None
    mine = None
    for c in range(candidate):
        ranks = [dist.get_global_rank(group, d * candidate + c) for d in range(rows)]
        g = dist.new_group(ranks)
        if hybrid_layout(dist.get_rank(group), candidate)[1] == c:
            mine = g
    return mine
