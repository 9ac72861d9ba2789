"""SCST rewards: CIDEr-D over token ids (``cider_d.py``, with the native
engine of ``csrc/cider_d.cpp`` built by ``native.py``) and the
sampled-vs-greedy reward assembly (``self_critical.py``)."""
