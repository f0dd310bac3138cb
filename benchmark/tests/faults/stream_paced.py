"""A stream cell's faults: a chunk step that returns its state
unchanged, a chunk's samples altered where they are produced."""


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


FAULTS = (stream_state_unchanged, chunk_altered)
