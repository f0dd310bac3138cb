"""Share of the card's bf16 dense peak spent on useful work in the
untraced window: benchmark/flops.py's count of the passes done over the
window's wall seconds."""


def read(facts):
    if facts.kind != "eval_utterances" or not facts.flops:
        return None
    return 100.0 * facts.flops / facts.window_s / (facts.peak_tflops * 1e12)
