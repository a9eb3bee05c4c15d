# repro_torch.examples — the port's twins of examples/: each runs as
# `python -m repro_torch.examples.<name>`, on the card unless given
# --device cpu; all work sits under main(argv) -> dict.
