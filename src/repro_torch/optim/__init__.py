# repro_torch.optim — the port's copies of repro.optim: AdamW and
# Adafactor as functions over trees of tensors, and the LR schedules.
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Optimizer", "adafactor", "adamw", "constant", "warmup_cosine"]
