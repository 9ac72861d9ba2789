"""Decoding and serving: step functions, sampling, beam search, the
batching caption server and its HTTP front end."""
