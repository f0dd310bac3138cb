"""Training: the pretraining and NSVAE trainers, their epoch loop,
optimizers and checkpoints."""
