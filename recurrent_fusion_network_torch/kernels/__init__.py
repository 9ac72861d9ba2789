"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and with a launch counter (see ``additive_attention.py``)."""
