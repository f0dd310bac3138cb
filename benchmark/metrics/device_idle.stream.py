"""Share of the traced chunks' processing intervals (from a chunk's
call to its samples on the host; the paced wait between chunks is not
the program's) in which nothing ran on the card."""


def read(facts):
    t = facts.trace
    if facts.kind != "stream_paced" or t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_in_marks_s / t.marks_s)
