"""Training-side modules of the port: checkpoint loading, the XE and SCST
criterions, the optimizer, and the XE and SCST train loops."""
