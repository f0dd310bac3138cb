"""Wall milliseconds of the program's LSTM span (idccrn.lstm, around
ComplexLSTM.forward and its step loop) per second of audio, over the
traced passes."""


def read(facts):
    sp = facts.spans
    if facts.kind != "eval_utterances" or sp is None:
        return None
    wall = sp.wall_s.get("idccrn.lstm")
    return 1e3 * wall / facts.trace_work["audio_s"] if wall else None
