"""repro_torch.checkpoint — crash-safe tensor-tree files (stdlib header,
raw tensor bytes), the storage under the durable serving layer."""
from repro_torch.checkpoint.io import (MAGIC, CheckpointError,  # noqa: F401
                                       read_meta, restore, save)
