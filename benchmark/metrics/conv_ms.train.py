"""Device milliseconds under aten convolution ops, forward and backward,
per training step, over the traced steps."""


def read(facts):
    t = facts.trace
    if facts.kind != "train_step" or t is None or not t.kernels:
        return None
    return 1e3 * t.seconds_under("conv") / facts.trace_work["steps"]
