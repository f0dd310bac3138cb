"""Share of the card's peak for the step's precision (f32 with cuDNN's
TF32: the TF32 dense peak) spent on useful work in the untraced window:
benchmark/flops.py's count of the steps done, forward and backward, over
the window's wall seconds."""


def read(facts):
    if facts.kind != "train_step" or not facts.flops:
        return None
    return 100.0 * facts.flops / facts.window_s / (facts.peak_tflops * 1e12)
