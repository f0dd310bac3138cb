"""A training cell's faults: a step that leaves its state unchanged,
half of the batch left out with the mean taken over the rest."""

import torch


def state_unchanged(monkeypatch):
    """Adam's step leaves the parameters and its state as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def batch_halved(monkeypatch):
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    inner = PretrainTrainer.train_step

    def step(self, batch, generator, epoch, skip_coin=None, noise=None):
        h = len(batch) // 2
        return inner(self, batch[:h], generator, epoch, skip_coin,
                     tuple(e[:h] for e in noise))
    monkeypatch.setattr(PretrainTrainer, "train_step", step)


FAULTS = (state_unchanged, batch_halved)
