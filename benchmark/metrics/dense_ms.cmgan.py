"""Device milliseconds of the kernels launched under the dense encoder
and both decoders (idccrn.cmgan.enc, .dec.mask, .dec.complex: the dilated
dense blocks, the strided and sub-pixel convs, the instance norms) per
second of audio, over the traced passes."""

SPANS = ("idccrn.cmgan.enc", "idccrn.cmgan.dec.mask",
         "idccrn.cmgan.dec.complex")


def read(facts):
    sp = facts.spans
    if facts.kind != "eval_utterances" or sp is None:
        return None
    dev = sum(sp.device_s.get(name, 0.0) for name in SPANS)
    return 1e3 * dev / facts.trace_work["audio_s"] if dev else None
