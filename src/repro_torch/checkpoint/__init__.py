"""The port's checkpoints."""
