"""The serving lane of the port: dense KV cache, two-phase engine (CUDA
graphs on the card), continuous-batching scheduler with the resilience
plane, SLO grading and the CLI (``python -m tpudist_torch.serve``)."""
