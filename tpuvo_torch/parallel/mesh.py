"""Process groups and device meshes (twin of ``tpuvo/parallel/mesh.py``).

The JAX package scales over ``jax.sharding.Mesh`` + ``shard_map``; the port
runs one process per card, joined by ``torch.distributed`` (NCCL on the
card, gloo for CPU tensors), with a ``DeviceMesh`` naming the axes:

  * ``lm``    — the landmark/map axis: sharded matcher columns, sharded BA
                landmark blocks (the pose graph's ``edge`` axis likewise)
  * ``batch`` — independent sequences (data parallel)

Each sharded function takes the mesh and an axis name, as in JAX; on a
rank it works on its own block of the sharded arrays and meets the other
ranks only in the collectives below.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# torchrun's contract: a launched process finds its group through these
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
INIT_TIMEOUT = timedelta(minutes=5)


def maybe_distributed_init(device="cuda") -> int:
    """Join the process group torchrun describes (a no-op otherwise);
    returns the world size.

    When the launcher's variables (``TORCHRUN_ENV``) are set, the process
    joins ``tcp://MASTER_ADDR:MASTER_PORT`` as ``RANK`` of ``WORLD_SIZE``:
    over NCCL on card ``LOCAL_RANK`` by default, over gloo when the caller
    asks for the CPU (``device="cpu"``).  A failed initialization RAISES,
    as in the JAX package: a job launched as several ranks that went on
    alone would shard nothing and reduce with itself.  Called at CLI
    start-up."""
    if dist.is_initialized():
        return dist.get_world_size()
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return 1
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed launch: {', '.join(present)} set but "
                           f"{', '.join(missing)} missing (launch with torchrun)")
    env = {k: os.environ[k] for k in TORCHRUN_ENV}
    try:
        port, rank, world, local = (int(env[k]) for k in TORCHRUN_ENV[1:])
    except ValueError as e:
        raise RuntimeError(f"distributed launch: bad torchrun variables {env}") from e
    if not 0 < port < 65536 or not 0 <= rank < world:
        raise RuntimeError(f"distributed launch: bad torchrun variables {env}")
    if torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(local)  # raises without that card
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{port}",
                            rank=rank, world_size=world, timeout=INIT_TIMEOUT)
    return world


def local_mesh(n_devices: int | None = None, axis: str = "lm",
               device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ranks of the process group (one card, or one CPU
    process, each); ``n_devices`` must be the world size when given."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {dist.get_world_size()}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def mesh_2d(n_batch: int, n_lm: int, device_type: str = "cuda") -> DeviceMesh:
    """(batch, lm) mesh for combined data x landmark sharding."""
    return init_device_mesh(device_type, (n_batch, n_lm), mesh_dim_names=("batch", "lm"))


def axis_info(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's index) of one named mesh axis."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)


def all_reduce_sum_(buf, group):
    """Sum ``buf`` over the group's ranks in place and return it (one
    collective)."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def all_gather_stack(buf, group, size: int):
    """Every rank's ``buf`` stacked on a new leading axis in rank order (one
    collective; the list form, which gloo and NCCL both take)."""
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf.contiguous(), group=group)
    return torch.stack(parts)
