# repro_torch.train — step builders (the port of repro.train.steps; the
# GNN family in this slice).
