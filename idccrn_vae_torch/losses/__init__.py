"""Losses of the pretraining, NSVAE, phase-2 and supervised stages, each
implemented once (complex-Gaussian math in complex_gaussian.py,
reconstruction terms in recon.py); the loss classes compose them."""
