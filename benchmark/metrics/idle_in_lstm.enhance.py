"""Share of the traced passes' idle card time (no kernel, copy or set
running) that falls while the LSTM span is the innermost span open: the
host launching the step loop."""


def read(facts):
    sp, t = facts.spans, facts.trace
    if facts.kind != "eval_utterances" or sp is None \
            or not sp.wall_s.get("idccrn.lstm"):
        return None
    return 100.0 * sp.idle_s.get("idccrn.lstm", 0.0) / (t.window_s - t.busy_s)
