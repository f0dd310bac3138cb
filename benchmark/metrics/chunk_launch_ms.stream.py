"""Median wall milliseconds of a traced chunk's entry span
(idccrn.stream.chunk: one process_chunk call, the copy of its input and
its launches; the samples' copy to the host follows it), over the traced
paced chunks."""

import statistics


def read(facts):
    sp = facts.spans
    if facts.kind != "stream_paced" or sp is None:
        return None
    chunks = sp.items_s.get("idccrn.stream.chunk")
    return 1e3 * statistics.median(chunks) if chunks else None
