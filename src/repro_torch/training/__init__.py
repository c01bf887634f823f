"""Training: the fault-tolerant trainer, the optimizers, checkpoints and
int8 gradient compression (``repro.training``)."""
from repro_torch.training.optimizer import (Optimizer, adafactor, adamw,
                                            global_norm, sgd_momentum)
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "Optimizer", "adamw", "adafactor",
           "sgd_momentum", "global_norm"]
