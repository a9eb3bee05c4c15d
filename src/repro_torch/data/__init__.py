# repro_torch.data — the port of repro.data: the synthetic batches
# (synthetic.py, numpy only) and the prefetch pipeline and graph sources
# (pipeline.py).
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.data import synthetic
