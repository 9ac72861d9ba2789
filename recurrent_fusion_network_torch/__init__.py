"""PyTorch / CUDA port of the RFNet captioning framework.

Runs beside the JAX package ``recurrent_fusion_network_tpu`` (the
reference) and imports nothing of it: module names mirror the JAX package
so each module's counterpart is easy to find. Entry points run on the CUDA
device unless the caller asks for ``device="cpu"`` (see ``device.py``).
The additive-attention read runs as a hand-written CUDA kernel
(``kernels/additive_attention.py``, ``csrc/additive_attention.cu``).
"""
