from repro_torch.optim.fedopt import FedAdam, FedAvgServer, ServerOptimizer
from repro_torch.optim.sgd import momentum_init, momentum_step, sgd_step

__all__ = [
    "ServerOptimizer",
    "FedAvgServer",
    "FedAdam",
    "sgd_step",
    "momentum_init",
    "momentum_step",
]
