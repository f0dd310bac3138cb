"""Training: the pretraining, NSVAE, phase-2 and supervised trainers,
their epoch loop, optimizers and checkpoints."""
