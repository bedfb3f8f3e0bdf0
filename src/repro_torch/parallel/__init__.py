"""Layout configuration of the port (one card: no mesh)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    ShardConfig,
    shard_config_from_knobs,
)
