"""The plain reference: RFNet and ReviewNet written out from the papers'
equations in plain PyTorch (``models``), the XE step with its criterion,
clamp, weight decay and Adam (``xe``), and the numbers the comparison
reads (``compare``).

It imports nothing but torch and numpy: neither JAX, nor the JAX package,
nor anything of the port. It gets from the benchmark the weights, the
features and the captions (made from the seed) and the program's outputs
to judge, and works out everything else again.
"""
