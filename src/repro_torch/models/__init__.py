# repro_torch.models — the port's copies of repro.models, as nn.Modules
# whose parameter names are repro's tree paths ("w0", "phi_e0.l0.w",
# "blk0.bilinear", "item.table", "blocks.attn.wq"): the shared layers,
# the GNNs, DimeNet, the embedding tables, DIEN, and the LMs (attention,
# MoE and the decoder with its serving path).
