# repro_torch.models — the port's copies of repro.models, as nn.Modules
# whose parameter names are repro's tree paths ("w0", "phi_e0.l0.w").
# This slice holds the layers the GNNs need and the GNNs themselves.
