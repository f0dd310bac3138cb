"""Share of the frames that the Enhancer's bucketing fed the program over
the traced passes that are padding: from its counters read around them,
(padded_frames - real_frames) / padded_frames."""


def read(facts):
    c = facts.counters
    if facts.kind != "eval_utterances" or not c.get("padded_frames"):
        return None
    return 100.0 * (c["padded_frames"] - c["real_frames"]) / c["padded_frames"]
