"""An eval cell's faults: an answer altered where it is produced, half
of each batch left out."""

import numpy as np


def answers_altered(monkeypatch):
    from idccrn_vae_torch.eval.enhance import Enhancer

    inner = Enhancer.enhance_utterances
    monkeypatch.setattr(Enhancer, "enhance_utterances", lambda *a, **k: [
        np.concatenate([o[:1], -o[1:]]) for o in inner(*a, **k)])


def rows_halved(monkeypatch):
    """Each batch enhanced on its first half of rows; the other rows
    get those answers."""
    from idccrn_vae_torch.eval.enhance import Enhancer

    inner = Enhancer.forward

    def forward(self, wav, generator=None, noise=None, noise_n=None):
        h = max(1, wav.shape[0] // 2)
        out = inner(self, wav[:h], generator)
        return out.repeat((wav.shape[0] + h - 1) // h, 1)[: wav.shape[0]]
    monkeypatch.setattr(Enhancer, "forward", forward)


FAULTS = (answers_altered, rows_halved)
