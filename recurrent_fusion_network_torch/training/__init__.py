"""Training-side modules of the port: checkpoint loading, the XE criterion,
optimizer and train loop."""
