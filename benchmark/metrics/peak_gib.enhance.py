"""Peak device memory allocated during the untraced evaluation window
(max_memory_allocated after a reset at the window's start), GiB."""


def read(facts):
    if facts.kind != "eval_utterances" or not facts.window_peak_bytes:
        return None
    return facts.window_peak_bytes / 2**30
