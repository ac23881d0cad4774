"""The port's ("data", "model") mesh over a ``torch.distributed`` world
(counterpart of parallel/mesh.py, whose GSPMD placement inserts every
collective; here the collectives are written out in parallel/comm.py).

Ranks are laid out data-major, as the JAX package lays devices out
(``np.asarray(devices).reshape(data, model)``): rank = d * model + m. Each
rank belongs to one "data" group (the ranks of its model index m, over
which the batch is split and the gradients are summed) and one "model"
group (the ranks of its data index d, over which heads, feed-forward
columns, experts, the sequence or the pipeline stages are split).

``backend`` is explicit: "nccl" runs one GPU per rank (``cuda:local_rank``)
and raises when there are fewer GPUs than ranks; "gloo" runs on the CPU,
or on CUDA tensors through host memory when the caller passes
``device="cuda"`` (several ranks may then share one card). The world is
joined from ``RANK`` / ``WORLD_SIZE`` (torchrun's variables, or those of
``parallel.launch.spawn``), with ``V2M_INIT_METHOD`` (a ``file://`` path)
or torchrun's ``env://`` rendezvous.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from .comm import Group

DATA_AXIS = "data"
MODEL_AXIS = "model"
INIT_METHOD_ENV = "V2M_INIT_METHOD"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its groups on both axes, the device
    its tensors live on and the world's backend."""
    spec: MeshSpec
    rank: int
    data: Group
    model: Group
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.spec.data, MODEL_AXIS: self.spec.model}

    @property
    def is_main(self) -> bool:
        """Rank 0, which alone writes files."""
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _spec(spec, world: int) -> MeshSpec:
    if spec is None:
        return MeshSpec(data=world, model=1)
    if isinstance(spec, tuple):
        spec = MeshSpec(*spec)
    if spec.data == -1:
        spec = MeshSpec(world // spec.model, spec.model)
    return spec


def _device(backend: str, device, local_rank: int, world: int):
    dev = torch.device("cpu" if device is None and backend == "gloo"
                       else device or "cuda")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; pass "
                             "backend='gloo' for a CPU mesh")
        return dev
    n_gpus = torch.cuda.device_count()
    if backend == "nccl" and n_gpus < world:
        raise ValueError(
            f"nccl runs one GPU per rank: {world} ranks, {n_gpus} GPUs "
            "(several ranks share a card only over gloo, device='cuda')")
    if n_gpus == 0:
        raise ValueError("device='cuda' but CUDA is not available")
    return torch.device("cuda", local_rank % n_gpus)


def create_mesh(spec: MeshSpec | tuple | None = None, *, backend: str,
                device=None, init_method: Optional[str] = None,
                rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Mesh:
    """Join (or reuse) the world and build its ("data", "model") mesh.

    ``spec``: a MeshSpec, a (data, model) tuple (-1 on the data axis: what
    is left after the model axis) or None (every rank on the data axis).
    ``backend``: "nccl" (CUDA, one GPU per rank) or "gloo" (CPU, or CUDA
    through host memory with ``device="cuda"``). The mesh must cover the
    world exactly."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = _env_int("RANK", 0) if rank is None else rank
        world = (_env_int("WORLD_SIZE", 1) if world_size is None
                 else world_size)
    spec = _spec(spec, world)
    n = spec.n_devices
    if n > world:
        raise ValueError(
            f"mesh {spec.data}x{spec.model} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {spec.data}x{spec.model} covers {n} of the "
                         f"world's {world} ranks; start {n} ranks")
    dev = _device(backend, device, _env_int("LOCAL_RANK", rank), world)
    if not dist.is_initialized():
        init = init_method or os.environ.get(INIT_METHOD_ENV, "env://")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    elif dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()}, not "
                         f"{backend}")
    D, M = spec.data, spec.model
    d, m = divmod(rank, M)
    groups = {}
    # every rank creates every group, in one order (a collective call)
    for axis, members in (
            ("data", [[di * M + mi for di in range(D)] for mi in range(M)]),
            ("model", [[di * M + mi for mi in range(M)] for di in range(D)])):
        mine = members[m] if axis == "data" else members[d]
        pg = None
        for ranks in members:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if ranks == mine:
                    pg = g
        groups[axis] = Group(pg, mine.index(rank), len(mine), tuple(mine),
                             backend)
    return Mesh(spec, rank, groups["data"], groups["model"], dev, backend)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of a global batch dict (numpy arrays or tensors):
    the batch axis split evenly over "data"."""
    d = mesh.data
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % d.size:
            raise ValueError(f"batch of {B} not divisible by the data-axis "
                             f"size {d.size}")
        n = B // d.size
        out[k] = v[d.rank * n:(d.rank + 1) * n]
    return out
