"""Serving entry points of the port."""

from idccrn_vae_torch.eval.metrics import (  # noqa: F401
    EvalMetrics,
    compute_mean,
    compute_median,
    compute_rmse,
    compute_sisdr,
    stoi,
)
