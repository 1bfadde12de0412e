"""Host utilities of the port: checkpointing."""
