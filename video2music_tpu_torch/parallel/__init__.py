"""Multi-GPU training of the port (counterpart of parallel/): the
("data", "model") mesh over ``torch.distributed``, the collectives,
the shard plan, the GPipe pipeline and a launcher for a world of ranks on
one machine. ``comm`` and ``mesh`` import torch alone; the rest load on
first use (the model's modules import ``comm``)."""

from .comm import Group
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, MeshSpec, create_mesh, \
    shard_batch

_LAZY = {
    "shard_plan": "shard", "Split": "shard", "shard_model_": "shard",
    "shard_optimizer_": "shard", "gather_state_dict": "shard",
    "gather_optimizer_state": "shard", "STRATEGIES": "shard",
    "microbatch": "pipeline", "unmicrobatch": "pipeline",
    "stack_subtrees": "pipeline", "unstack_subtrees": "pipeline",
    "pipeline_apply": "pipeline",
    "spawn": "launch",
}

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Group", "Mesh", "MeshSpec",
           "create_mesh", "shard_batch", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
