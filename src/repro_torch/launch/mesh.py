"""Production mesh shapes and the sharding-policy factory (port of
``repro.launch.mesh``).

The port plans on the reference's logical layout, so that its per-device
figures compare with the reference's: ``make_production_mesh`` returns the
mesh as an ``{axis: size}`` shape, (16, 16) over ``("data", "model")`` or
(2, 16, 16) over ``("pod", "data", "model")``.  It touches no device.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPolicy

FSDP_PARAM_THRESHOLD = 8e9  # shard weights over the data axis above this


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_policy(cfg: ModelConfig, mesh, *, rules=None) -> ShardingPolicy:
    pol = ShardingPolicy(mesh=mesh)
    pol.enable_fsdp = cfg.total_params >= FSDP_PARAM_THRESHOLD
    if rules:
        pol.rules.update(rules)
    return pol
