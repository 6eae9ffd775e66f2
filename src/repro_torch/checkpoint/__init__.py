"""Checkpoints of the port (the copy of ``repro.checkpoint``): the
manager, sharded manifests and delta ("P-frame") chains."""

from .delta import (DELTA_FILE, DeltaBaseMissingError,  # noqa: F401
                    DeltaChainError, base_ref, base_step_of, chain_files,
                    resolve_chain, restore_flat_delta, restore_levels,
                    write_delta)
from .manager import CheckpointConfig, CheckpointManager  # noqa: F401
from .sharded import (MANIFEST_NAME, MeshSpec, RestoreStats,  # noqa: F401
                      assemble_slice, load_manifest, restore_flat,
                      verify_files, write_sharded)
