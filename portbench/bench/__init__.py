"""The harness's own code: the layout loader, the frozen FLOP and byte
formulas, the weights made from the seed, the trace reduction and the
comparison that decides ``correct``."""
