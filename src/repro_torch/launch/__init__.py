# repro_torch.launch — command-line entry points of the port.
