"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven at the
tests' width on the CPU (float32, so that a sound run reads round-off
alone), once per fault each cell can have. One chip: no exchange
between chips to leave out."""

import numpy as np
import pytest
import torch

from benchmark.tests.test_bench_harness import small_run

E = "idccrn_vae_z128.eval_s10"
D = "idccrn_vae_dual_z128.eval_s10"
T = "idccrn_vae_z128.train_b16"
S = "idccrn_vae_z128.stream_b1"


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


def stream_state_unchanged(monkeypatch):
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    inner = StreamingEnhancer._chunk_step
    monkeypatch.setattr(StreamingEnhancer, "_chunk_step",
                        lambda self, state, chunk:
                        (inner(self, state, chunk)[0], state))


def chunk_altered(monkeypatch):
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    inner = StreamingEnhancer._chunk_step

    def step(self, state, chunk):
        out, state = inner(self, state, chunk)
        return -out, state
    monkeypatch.setattr(StreamingEnhancer, "_chunk_step", step)


@pytest.mark.parametrize("cell,fault", [
    (E, answers_altered), (E, rows_halved),
    (D, answers_altered), (D, rows_halved),
    (T, state_unchanged), (T, batch_halved),
    (S, stream_state_unchanged), (S, chunk_altered),
])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    fault(monkeypatch)
    line = small_run(cell, False, compute="f32")
    assert line["correct"] is False, line["checks"]
