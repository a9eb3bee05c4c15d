# repro_torch.data — the port's copy of repro.data.synthetic (numpy
# only). The prefetch pipeline and the SNAP loaders of
# repro.data.pipeline come with a later slice.
