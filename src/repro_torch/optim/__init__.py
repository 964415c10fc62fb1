from repro_torch.optim.optimizers import OptState, Optimizer, sgd_momentum
