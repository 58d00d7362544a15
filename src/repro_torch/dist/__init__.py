"""Distribution subsystem of the port (``repro.dist``) on
``torch.distributed``: sharding rules, tuned collectives, pipeline
parallelism.

  * ``sharding``     — logical-axis -> mesh-axis rules with graceful
                       degradation (non-divisible dims replicate, reported),
                       as DTensor placements on a ``DeviceMesh``; and the
                       fleet-slot partition rule of the sharded fleet engine.
  * ``collectives``  — gradient flatten/bucket/quantize all-reduce, plus the
                       paper bridge: a netsim model of the accelerators'
                       interconnect that lets ``TransferTuner`` optimize the
                       bucketing parameters.
  * ``pipeline_par`` — GPipe-style pipeline parallelism over a ``stage``
                       mesh dimension by point-to-point sends on the ring.
  * ``tensor_parallel`` — the weights split over the mesh's ``model`` axis.
  * ``fsdp``         — the weights cut over the mesh's ``data`` axis,
                       gathered a layer at a time for compute.

The reference's ``compat`` module has no counterpart: it spells
``shard_map`` for several JAX versions, and ``torch.distributed`` has one
spelling of everything used here.
"""
from repro_torch.dist.sharding import slot_partition, slot_shard

__all__ = ["slot_partition", "slot_shard"]
