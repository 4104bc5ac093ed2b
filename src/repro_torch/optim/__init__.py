from repro_torch.optim.optimizers import AdamW, Optimizer, SGD  # noqa: F401
