"""Losses of the pretraining, NSVAE, phase-2 and supervised stages, each
implemented once (complex-Gaussian math in complex_gaussian.py,
reconstruction terms in recon.py); the loss classes compose them."""

from idccrn_vae_torch.losses.complex_gaussian import (  # noqa: F401
    complex_gaussian_log_prob,
    complex_kl_divergence,
    standard_prior_like,
)
from idccrn_vae_torch.losses.recon import (  # noqa: F401
    si_snr_loss,
    multiple_recon_loss,
    prob_recon_loss,
)
from idccrn_vae_torch.losses.vae_loss import (  # noqa: F401
    kl_annealing_schedule,
    PretrainVaeLoss,
)
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss  # noqa: F401
from idccrn_vae_torch.losses.phase2 import (  # noqa: F401
    TwoPhaseLoss,
    AdversarialPhase2Loss,
    EteTrainSeLoss,
)
