# repro_torch.models — the port's copies of repro.models, as nn.Modules
# whose parameter names are repro's tree paths ("w0", "phi_e0.l0.w",
# "blk0.bilinear", "item.table"): the shared layers, the GNNs, DimeNet,
# the embedding tables and DIEN. The LM layers come with their slice.
