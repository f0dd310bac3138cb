"""Median latency of the window's chunks, from due time to samples on the
host."""

import statistics


def read(facts):
    if facts.kind != "stream_paced" or not facts.latencies_ms:
        return None
    return statistics.median(facts.latencies_ms)
