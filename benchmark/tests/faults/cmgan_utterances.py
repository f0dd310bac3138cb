"""A CMGAN eval cell's faults: an answer altered where it is produced,
half of each batch left out."""

import numpy as np


def answers_altered(monkeypatch):
    from idccrn_vae_torch.eval.enhance import CmganEnhancer

    inner = CmganEnhancer.enhance_utterances
    monkeypatch.setattr(CmganEnhancer, "enhance_utterances", lambda *a, **k: [
        np.concatenate([o[:1], -o[1:]]) for o in inner(*a, **k)])


def rows_halved(monkeypatch):
    """Each batch enhanced on its first half of rows; the other rows
    get those answers."""
    from idccrn_vae_torch.eval.enhance import CmganEnhancer

    inner = CmganEnhancer.forward

    def forward(self, wav, lengths=None):
        h = max(1, wav.shape[0] // 2)
        out = inner(self, wav[:h], None if lengths is None else lengths[:h])
        return out.repeat((wav.shape[0] + h - 1) // h, 1)[: wav.shape[0]]
    monkeypatch.setattr(CmganEnhancer, "forward", forward)


FAULTS = (answers_altered, rows_halved)
