"""Training-side modules of the port (this slice: checkpoint loading)."""
