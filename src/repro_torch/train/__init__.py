"""The port's train step."""
