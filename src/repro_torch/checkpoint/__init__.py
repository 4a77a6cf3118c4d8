from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointCorruptError, Checkpointer, CheckpointSizes, LeaseLostError,
    WriterLease,
)
