"""Plain fp32 references, one file a configuration, written from the
published equations. They import nothing of JAX, of the JAX package or
of the port."""
