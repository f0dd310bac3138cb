"""Peak device memory allocated during the untraced training window
(max_memory_allocated after a reset at the window's start), GiB."""


def read(facts):
    if facts.kind != "train_step" or not facts.window_peak_bytes:
        return None
    return facts.window_peak_bytes / 2**30
