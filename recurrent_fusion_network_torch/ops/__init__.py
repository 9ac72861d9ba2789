"""Tensor ops of the port: initializers, attention and the LSTM cells."""
