"""Device milliseconds under aten convolution ops (cuDNN's convs and
transposed convs, with their layout passes) per second of audio, over
the traced pass."""


def read(facts):
    t = facts.trace
    if facts.kind != "eval_utterances" or t is None or not t.kernels:
        return None
    return 1e3 * t.seconds_under("conv") / facts.trace_work["audio_s"]
