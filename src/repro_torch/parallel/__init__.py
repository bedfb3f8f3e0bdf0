"""Layout configuration of the port, and the proposer's device helpers
(the candidate pool's shards, the spare card for background refits)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    POOL_AXIS,
    ShardConfig,
    data_parallel_size,
    pool_devices,
    shard_config_from_knobs,
    spare_device,
)
