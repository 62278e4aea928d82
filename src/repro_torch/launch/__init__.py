"""Launch-time layout: the sampler's client-axis shard layout (``mesh``)."""
