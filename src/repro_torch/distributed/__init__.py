"""Distribution of the port: the sharding rules (per-dim mesh axes of a
tensor, and their DTensor placements on a ``torch.distributed``
``DeviceMesh``), error-feedback gradient compression and the compressed
cross-pod sum (``compress``), the data-parallel batch group of the train
steps (``data_parallel``) and GPipe stages over a mesh axis
(``pipeline_stage``)."""
