"""Device milliseconds under aten matrix products (the LSTM's step and
input products, the dense layer) per second of audio, over the traced
pass."""


def read(facts):
    t = facts.trace
    if facts.kind != "eval_utterances" or t is None or not t.kernels:
        return None
    return 1e3 * t.seconds_under("matmul") / facts.trace_work["audio_s"]
