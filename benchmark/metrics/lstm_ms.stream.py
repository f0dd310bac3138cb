"""Wall milliseconds of the LSTM span (idccrn.lstm) per chunk, over the
traced paced chunks."""


def read(facts):
    sp = facts.spans
    if facts.kind != "stream_paced" or sp is None:
        return None
    wall = sp.wall_s.get("idccrn.lstm")
    return 1e3 * wall / facts.trace_work["chunks"] if wall else None
