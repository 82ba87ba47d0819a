"""Distributed pieces of the port: gradient compression
(:mod:`~repro_torch.distributed.collectives`, on one device) and the
replica-axis mesh's sharding (:mod:`~repro_torch.distributed.sharding`:
the TM fleet, the service and the cross-validation engine in slabs over
a list of devices, one process driving them all). The LM half of the
mesh (``ShardingPolicy``, ``spec_partition``, ``param_/batch_/
cache_shardings``, ``autoshard``, FSDP / TP over ``torch.distributed``)
waits for ROADMAP queue 1."""
