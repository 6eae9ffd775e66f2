"""Distribution of the port: the sharding rules (per-dim mesh axes of a
tensor, as a checkpoint manifest and the train state's specs need them)
and error-feedback gradient compression on one card; the collectives and
mesh placement wait for the distribution slice."""
