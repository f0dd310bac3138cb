"""Device milliseconds of the kernels launched under the TSCB span
(idccrn.cmgan.tscb) with no attention span inside it open: the FFNs,
the conv module, the norms and the transposes between the time and the
frequency axis, per second of audio, over the traced passes."""


def read(facts):
    sp = facts.spans
    if facts.kind != "eval_utterances" or sp is None:
        return None
    dev = sp.device_s.get("idccrn.cmgan.tscb")
    return 1e3 * dev / facts.trace_work["audio_s"] if dev else None
