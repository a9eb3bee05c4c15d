# repro_torch.distributed — the port of repro.distributed: the logical
# axis -> mesh axis rules (sharding.py) and int8 gradient compression
# across pods (compression.py), over torch.distributed.
