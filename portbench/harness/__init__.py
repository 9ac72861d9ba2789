"""The benchmark's machinery: environment and checks (``env``), seeded
weights, corpus and feature pool (``weights``, ``data``), the profiler
window (``trace``), the arithmetic of operations and bytes
(``model_math``), and the per-layer metric readers' loader
(``readers``)."""
