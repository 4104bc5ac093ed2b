from repro_torch.optim.optimizers import (  # noqa: F401
    SGD, Adafactor, AdamW, Optimizer, make_optimizer)
