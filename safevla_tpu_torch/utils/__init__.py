"""Host utilities of the port: metrics, string codec, step timing, checkpoints."""
