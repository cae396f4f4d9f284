from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.optim.schedules import cosine, linear, make_schedule, wsd
from repro_torch.optim import quant

__all__ = ["AdamW", "AdamWConfig", "cosine", "linear", "make_schedule",
           "wsd", "quant"]
