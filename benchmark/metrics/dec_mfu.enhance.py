"""The decoders' share of the bf16 dense peak: benchmark/flops.py's
decoder FLOPs of the traced passes (`trace_work["dec_flops"]`) over the
device seconds of the kernels launched under the decoder span
(idccrn.dec)."""


def read(facts):
    sp = facts.spans
    if facts.kind != "eval_utterances" or sp is None:
        return None
    dec_s, work = sp.device_s.get("idccrn.dec"), facts.trace_work
    if not dec_s or not work.get("dec_flops"):
        return None
    return 100.0 * work["dec_flops"] / (dec_s * facts.peak_tflops * 1e12)
