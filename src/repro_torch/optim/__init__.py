"""Optimizers of the port's training path."""
