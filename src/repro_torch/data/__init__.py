"""The port's training data."""
