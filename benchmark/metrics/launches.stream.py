"""Kernels launched per chunk, over the traced chunks."""


def read(facts):
    t = facts.trace
    if facts.kind != "stream_paced" or t is None or not t.kernels:
        return None
    return t.kernels / facts.trace_work["chunks"]
