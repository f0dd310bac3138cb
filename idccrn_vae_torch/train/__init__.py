"""Training: the pretraining, NSVAE, phase-2 and supervised trainers,
their epoch loop, optimizers and checkpoints."""

from idccrn_vae_torch.train.optim import (  # noqa: F401
    make_adam,
    PlateauScheduler,
    set_learning_rate,
    get_learning_rate,
)
from idccrn_vae_torch.train.checkpoint import CheckpointManager  # noqa: F401
