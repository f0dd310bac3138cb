"""Share of the traced training steps in which no kernel, copy or set
ran on the card: 100 x (1 - union of device intervals / traced wall)."""


def read(facts):
    t = facts.trace
    if facts.kind != "train_step" or t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
