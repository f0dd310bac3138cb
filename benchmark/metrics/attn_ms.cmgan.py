"""Device milliseconds of the kernels launched under the attention span
(idccrn.cmgan.attn, both axes of every TSCB) per second of audio, over
the traced passes."""


def read(facts):
    sp = facts.spans
    if facts.kind != "eval_utterances" or sp is None:
        return None
    dev = sp.device_s.get("idccrn.cmgan.attn")
    return 1e3 * dev / facts.trace_work["audio_s"] if dev else None
