"""Training-side modules of the port: checkpoint triples, the XE and SCST
criterions, the optimizer, the XE and SCST train loops, eval_split and the
preemption guard."""
