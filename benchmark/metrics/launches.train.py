"""Kernels launched per training step, over the traced steps."""


def read(facts):
    t = facts.trace
    if facts.kind != "train_step" or t is None or not t.kernels:
        return None
    return t.kernels / facts.trace_work["steps"]
