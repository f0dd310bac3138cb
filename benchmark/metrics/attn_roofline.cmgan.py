"""The relative-position attention kernel's share of its roofline over
the traced passes: the least time the card could take for the attention
the real lengths need (`benchmark/cmgan_flops.py`: 6 n_q n_k d FLOPs per
row and head, q . k, q . E and P v; q, k, v and the output read or
written once, the embedding once a call), max(FLOPs over the bf16 dense
peak, bytes over 3.35 TB/s), over the device seconds of the kernels
launched under the attention span (idccrn.cmgan.attn)."""

HBM_BYTES_S = 3.35e12  # H100 SXM5 data sheet


def read(facts):
    sp, work = facts.spans, facts.trace_work
    if facts.kind != "eval_utterances" or sp is None \
            or not work.get("attn_flops"):
        return None
    attn_s = sp.device_s.get("idccrn.cmgan.attn")
    if not attn_s:
        return None
    least = max(work["attn_flops"] / (facts.peak_tflops * 1e12),
                work["attn_bytes"] / HBM_BYTES_S)
    return 100.0 * least / attn_s
