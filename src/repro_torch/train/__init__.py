"""Training on PyTorch: the optimizers and learning-rate schedules
(:mod:`repro_torch.train.optim`) the baselines of Table I and the LM
cells train with, the production train loop with its checkpoints,
preemption save and resume (:mod:`repro_torch.train.loop`), and int8
gradient compression with error feedback
(:mod:`repro_torch.train.compress`)."""
