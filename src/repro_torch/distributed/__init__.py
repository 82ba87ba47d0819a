"""Distributed pieces of the port: gradient compression and the staged
collectives of ranks that share a card
(:mod:`~repro_torch.distributed.collectives`), the sharding rules of both
halves of the mesh (:mod:`~repro_torch.distributed.sharding`: the TM
fleet, the service and the cross-validation engine in slabs over a list
of devices, one process driving them all; the LM's parameters, moments
and batch as DTensors over a ``RankMesh`` of ``torch.distributed`` ranks,
FSDP over data and TP / EP over model), and the model's layout hints
(:mod:`~repro_torch.distributed.autoshard`)."""
