"""Kernels launched per second of audio enhanced, over the traced
pass."""


def read(facts):
    t = facts.trace
    if facts.kind != "eval_utterances" or t is None or not t.kernels:
        return None
    return t.kernels / facts.trace_work["audio_s"]
