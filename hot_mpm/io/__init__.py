"""Checkpoint/restart and frame output."""

from hot_mpm.io.checkpoint import save_checkpoint, load_checkpoint, save_frame  # noqa: F401
