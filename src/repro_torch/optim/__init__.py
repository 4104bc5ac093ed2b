from repro_torch.optim.optimizers import (  # noqa: F401
    SGD, AdamW, Optimizer, make_optimizer)
