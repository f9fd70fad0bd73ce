"""Checkpointing of the port (`checkpoint.ckpt`)."""
