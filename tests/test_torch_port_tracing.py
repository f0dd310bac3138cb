"""The port's named spans (`utils/profiling.py` `span`, `SPANS`) and the
Enhancer's padding counters, on the CPU at tiny geometry.

Under `torch.profiler` the serving, streaming and training paths record
their layer spans nested as the table in `profiling.SPANS` describes;
with no profiler recording a span is one shared no-op and leaves no
trace; a profiler around a call does not change its outputs. That the
exported programs carry no profiler op is held where they are exported
(test_torch_port_export.py, test_torch_port_export_cli.py).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from idccrn_vae_torch.eval.enhance import Enhancer
from idccrn_vae_torch.eval.streaming import StreamingEnhancer
from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
from idccrn_vae_torch.models.config import DccrnConfig, StftConfig
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.train.pretrain import PretrainTrainer
from idccrn_vae_torch.utils import profiling
from torch_port_util import TINY, TINY_STFT

# sorted: [37, 100], [160, 250], [400] at batch 2
LENGTHS = (250, 37, 400, 160, 100)
BUCKET_FRAMES = 16
BATCH = 2
ENC = ["idccrn.stft", "idccrn.enc", "idccrn.lstm", "idccrn.latent"]


def _cfg(stft=TINY_STFT, **kw) -> DccrnConfig:
    """TINY's widths; the streamer takes the default STFT, whose bins
    its carried columns need."""
    fields = dict(TINY, num_samples=2, **kw)
    return DccrnConfig(stft=StftConfig(**stft), **fields)


def _enhancer(outtype: str) -> Enhancer:
    dual = outtype != "clean_direct"
    enc_cfg, dec_cfg = _cfg(latent_num=2 if dual else 1), _cfg()
    gen = lambda k: torch.Generator().manual_seed(k)
    dec = lambda k: VaeDecoder(dec_cfg, device="cpu",
                               generator=gen(k)).state_dict()
    enc = NsvaeEncoder(enc_cfg, device="cpu", generator=gen(1)).state_dict()
    return Enhancer(enc_cfg, dec_cfg, enc, dec(2), dec(3) if dual else None,
                    num_samples=2, outtype=outtype,
                    latent_to_use=2 if dual else 1,
                    bucket_frames=BUCKET_FRAMES, device="cpu")


def _streamer() -> StreamingEnhancer:
    cfg = _cfg(stft={})
    gen = lambda k: torch.Generator().manual_seed(k)
    return StreamingEnhancer(
        cfg, cfg,
        NsvaeEncoder(cfg, device="cpu", generator=gen(1)).state_dict(),
        VaeDecoder(cfg, device="cpu", generator=gen(2)).state_dict(),
        chunk_frames=4, device="cpu")


def _trainer() -> PretrainTrainer:
    loss = PretrainVaeLoss(np.asarray([0.1], np.float32), 0.05,
                           num_samples=2)
    return PretrainTrainer(_cfg(), loss, 1e-3, device="cpu")


def _wavs():
    rng = np.random.default_rng(0)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32)
            for n in LENGTHS]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(prof):
    """The `idccrn.*` spans as nested [name, children] in start order,
    each span's parent the innermost span containing it on its thread."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.start_thread_id(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("idccrn.")),
                   key=lambda s: (s[0], -s[1]))
    roots, open_ = [], {}
    for a, b, thread, name in spans:
        stack = open_.setdefault(thread, [])
        while stack and stack[-1][0] <= a:
            stack.pop()
        node = [name, []]
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((b, node))
    return roots


def _names(nodes):
    return [n[0] for n in nodes]


def _enhance(enh, wavs):
    return enh.enhance_utterances(wavs, BATCH, generator=enh.new_generator(7))


@pytest.mark.parametrize("outtype", ["clean_direct", "real_imag_mask"])
def test_enhance_spans_and_outputs(outtype):
    enh, wavs = _enhancer(outtype), _wavs()
    plain = _enhance(enh, wavs)
    traced, prof = _profiled(lambda: _enhance(enh, wavs))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    roots = _tree(prof)
    # the padding runs in the bucketing generator, before its batch
    assert _names(roots) == ["idccrn.pad", "idccrn.enhance.batch"] * 3
    decode = ["idccrn.dec", "idccrn.istft"]
    if outtype == "clean_direct":
        want = ["idccrn.copy_in", *ENC, *decode, "idccrn.copy_out"]
    else:
        want = ["idccrn.copy_in", *ENC, *decode, *decode, "idccrn.mask",
                "idccrn.istft", "idccrn.copy_out"]
    for pad, batch in zip(roots[::2], roots[1::2]):
        assert pad[1] == []
        assert _names(batch[1]) == want
        assert all(child[1] == [] for child in batch[1])
    assert set(_names(roots)) | set(want) <= set(profiling.SPANS)


def test_stream_chunk_spans_and_outputs():
    st = _streamer()
    audio = (0.3 * np.random.default_rng(1).standard_normal(
        (1, 3 * st.chunk_samples))).astype(np.float32)

    def stream():
        state, outs = st.init_state(1), []
        for k in range(3):
            out, state = st.process_chunk(
                state, audio[:, k * st.chunk_samples:
                             (k + 1) * st.chunk_samples])
            outs.append(out)
        return torch.cat(outs, dim=1)

    plain = stream()
    traced, prof = _profiled(stream)
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)
    roots = _tree(prof)
    assert _names(roots) == ["idccrn.stream.chunk"] * 3
    for chunk in roots:
        assert _names(chunk[1]) == ["idccrn.copy_in", *ENC, "idccrn.dec",
                                    "idccrn.istft"]


def test_train_step_spans_and_outputs():
    batch = (0.3 * np.random.default_rng(2).standard_normal(
        (2, 400))).astype(np.float32)
    noise = tuple(torch.randn((2, 2, 51, TINY["zdim"]),
                              generator=torch.Generator().manual_seed(3))
                  for _ in range(2))
    runs = []
    for traced in (False, True):
        tr = _trainer()
        step = lambda: tr.train_step(batch, None, 0, noise=noise)
        metrics, prof = _profiled(step) if traced else (step(), None)
        runs.append((metrics, [p.detach().clone() for p in
                               (*tr.encoder.parameters(),
                                *tr.decoder.parameters())]))
    (m0, p0), (m1, p1) = runs
    assert {k: v.item() for k, v in m0.items()} == \
        {k: v.item() for k, v in m1.items()}
    for a, b in zip(p0, p1):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    roots = _tree(prof)
    assert _names(roots) == ["idccrn.train.step"]
    step = roots[0][1]
    assert _names(step) == ["idccrn.copy_in", "idccrn.train.forward",
                            "idccrn.train.backward", "idccrn.train.optimizer"]
    assert _names(step[1][1]) == [*ENC, "idccrn.dec", "idccrn.istft"]


def test_span_is_a_shared_noop_without_a_profiler():
    assert profiling.span("idccrn.lstm") is profiling.span("idccrn.enc")
    enh = _enhancer("clean_direct")
    _enhance(enh, _wavs()[:2])
    _, prof = _profiled(lambda: torch.ones(4) + 1)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("idccrn.")]
    assert all(name.startswith("idccrn.") for name in profiling.SPANS)


def test_spans_are_not_user_annotations():
    """A user annotation gets a copy on the device's timeline that would
    read as busy device time; a span is an op on its thread only."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("idccrn.lstm"):
            torch.ones(4) + 1
    got = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "idccrn.lstm"]
    assert len(got) == 1 and not got[0].is_user_annotation()


def test_enhancer_counters_count_the_padding():
    enh = _enhancer("clean_direct")
    _enhance(enh, _wavs())
    # real frames n // 8 + 1: 5, 13 | 21, 32 | 51; buckets of 16, 32, 64
    assert enh.counters == {"batches": 3, "rows": 5, "real_frames": 122,
                            "padded_frames": 2 * 16 + 2 * 32 + 64}
    enh.encode_latents(_wavs()[:2], BATCH)
    assert enh.counters["batches"] == 4

