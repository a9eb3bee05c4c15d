# repro_torch.configs — the port's copies of repro.configs: the shape
# sets, ArchSpec and the registry of the architectures ported so far.
