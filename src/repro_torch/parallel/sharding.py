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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


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
