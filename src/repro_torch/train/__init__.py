"""Training on PyTorch: the optimizers and learning-rate schedules
(:mod:`repro_torch.train.optim`) the baselines of Table I train with."""
