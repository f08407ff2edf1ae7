"""The serving lane of the port: dense KV cache, two-phase engine,
continuous-batching scheduler, SLO grading and the CLI
(``python -m tpudist_torch.serve``)."""
