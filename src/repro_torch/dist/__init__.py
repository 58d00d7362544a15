"""Distribution helpers of the port (the fleet-slot partition rule)."""
from repro_torch.dist.sharding import slot_partition, slot_shard

__all__ = ["slot_partition", "slot_shard"]
