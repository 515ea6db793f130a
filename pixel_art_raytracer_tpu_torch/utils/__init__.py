"""Host utilities: image writeback, metrics, checkpointing."""
