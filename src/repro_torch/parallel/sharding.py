"""Logical-axis layout configuration (from ``repro.parallel.sharding``).

Every parameter and activation of the model zoo carries logical axis
names; an :class:`AxisRules` table maps them to mesh axes, and the layout
knobs select the table (FSDP / TP / EP / SP).  The port runs on one card:
these are the typed destinations of the knobs, carried in ``RunConfig``
so knob dicts round-trip, and nothing reads them to place a tensor.
``ShardConfig.resolve(mesh)``, ``shard_activation`` and
``gather_weights_for_compute`` act only on a mesh and are not ported; off
a mesh the reference's two helpers are no-ops, and the port calls nothing
in their place.

The proposer's side is ported: the candidate pool of
``gp.select_batch_sharded`` shards over an ordered tuple of devices
(:func:`pool_devices`, axis :data:`POOL_AXIS`), and :func:`spare_device`
picks the card background work (the GP refit) runs on.  The reference's
``pool_mesh`` returns a ``jax.sharding.Mesh``; what it carries, the ordered
device tuple and its axis name, is :func:`pool_devices` and
:data:`POOL_AXIS` here.  No process group is involved: one process drives
every card of the tuple in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

POOL_AXIS = "pool"


def pool_devices(n: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda") -> Tuple:
    """The devices the proposer's candidate pool shards over: the first
    ``n`` cards of the host (all of them when ``n`` is None or exceeds
    the host), ``(cpu,)`` for a CPU strategy.  Deterministic order:
    shard k owns pool rows ``[k·M/nd, (k+1)·M/nd)``, so the tuple is part
    of the pick-reproducibility contract."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),)
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n is not None:
        devs = devs[:max(int(n), 1)]
    return devs


def spare_device(avoid_index: int = 0,
                 device: Union[str, torch.device] = "cuda"):
    """A card for background work (the GP refit executor): the *last*
    card of the host when it has more than one, never ``avoid_index``
    (the experiment loop's), else ``None`` (one card, or a CPU strategy:
    background work shares the device and only thread-yields)."""
    devs = pool_devices(None, device)
    if len(devs) <= 1:
        return None
    for d in reversed(devs):
        if d.index != avoid_index:
            return d
    return None


@dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to mesh axes (None = replicate)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def to_dict(self) -> Dict[str, MeshAxes]:
        return dict(self.rules)

    def with_rule(self, logical: str, mesh_axes: MeshAxes) -> "AxisRules":
        d = self.to_dict()
        d[logical] = mesh_axes
        return AxisRules(tuple(d.items()))

    def mesh_axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.to_dict().get(logical, None)


# The "megatron + fsdp" default layout on the fixed (data, model) mesh.
DEFAULT_RULES = AxisRules(
    (
        ("batch", ("data",)),          # activation batch
        ("seq", None),                 # sequence (SP off by default)
        ("embed", None),               # d_model dim of activations
        ("vocab", "model"),            # embedding table vocab dim
        ("emb_embed", None),           # embedding table d_model dim
        ("heads", "model"),            # attention heads (TP)
        ("kv_heads", "model"),         # kv heads (TP; requires kv>=tp or repl)
        ("head_dim", None),
        ("qkv_in", "fsdp"),            # contraction dim of qkv proj (FSDP)
        ("o_out", "fsdp"),             # output dim of o proj (FSDP)
        ("ff", "model"),               # MLP hidden (TP)
        ("ff_in", "fsdp"),             # MLP input dim (FSDP)
        ("experts", "model"),          # MoE expert dim (EP over model axis)
        ("expert_ff", "model"),        # TP inside experts when EP cannot
        ("expert_in", "fsdp"),
        ("kv_seq", None),              # KV-cache sequence dim
        ("ssm_inner", "model"),        # mamba/xlstm inner width (TP)
        ("ssm_in", "fsdp"),
        ("ssm_state", None),
        ("fsdp", None),                # placeholder resolved on a mesh
    )
)


@dataclass(frozen=True)
class ShardConfig:
    """Resolved distribution layout — the output of the layout knobs."""

    fsdp: bool = True                    # shard param "fsdp" dims over data axis
    tensor_parallel: bool = True         # map "model"-tagged dims to mesh model
    expert_parallel: bool = True         # shard experts over model axis
    sequence_parallel: bool = False      # shard activation seq over model axis
    shard_kv_seq_for_decode: bool = False  # flash-decode style KV seq sharding
    pod_in_batch: bool = True            # multi-pod: pod axis joins batch
    rules: AxisRules = DEFAULT_RULES


def shard_config_from_knobs(knobs: Dict[str, object]) -> ShardConfig:
    """Translate SAPPHIRE layout knobs into a ShardConfig (module selection)."""
    return ShardConfig(
        fsdp=bool(knobs.get("fsdp_shard_params", True)),
        tensor_parallel=bool(knobs.get("tensor_parallel", True)),
        expert_parallel=bool(knobs.get("expert_parallel", True)),
        sequence_parallel=bool(knobs.get("sequence_parallel", False)),
        shard_kv_seq_for_decode=bool(knobs.get("shard_kv_seq", False)),
        pod_in_batch=bool(knobs.get("pod_in_batch", True)),
    )
