"""tpudist_torch.bench — measurement tools beside the train and serve
lanes: :mod:`profile`, the step profiler (``python -m
tpudist_torch.bench.profile``)."""
