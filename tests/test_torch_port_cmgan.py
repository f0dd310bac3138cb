"""CMGAN's generator in the port (`models/cmgan.py`, `ops/rel_attention.py`,
`eval/enhance.py` `CmganEnhancer`, the Hamming STFT of `ops/stft.py`)
against a plain reference of upstream's code, `tests/cmgan_reference.py`
(float32 torch, nothing of either package, kept byte for byte equal to
the benchmark's `benchmark/reference/cmgan.py`), at a small width on the
CPU with seeded weights: 8 channels, 2 heads of 4, 2 TSCBs, n_fft 64, hop
16 (33 bins), `max_pos_emb` 12, below every length here, so that the
distance clip is exercised.

Tolerances:
  * float32: 1e-5 of the answer's L2 norm (read: 2e-7 to 6e-7); the two
    sides differ only in summation order and in the folded batch norm.
  * bf16: 0.02 relative L2 per utterance (read: 0.008-0.010). Every
    activation is stored in bf16 (unit round-off 2**-9 = 0.2%) through
    about 40 rounded layers in a row here (2 TSCBs of two conformers of 8
    products and norms, the dense blocks), which grows as their square
    root to about 1.2%, with room for the norms' gain. Rows left unmasked
    read 5-40% in float32; the relative term left out reads only 1.6-2.5%
    at this width (heads of 4), which the float32 test catches and this
    one cannot.
  * the CUDA kernel on the card: 1e-2 relative L2 (read: 6e-4 to 2.0e-3;
    the relative term dropped reads 0.19-0.76): it rounds the softmax's
    probabilities to bf16 for P v, the plain path does not.

One test needs a CUDA card (`card`, skipped without one); the file
imports nothing of JAX, so it runs on the card without `tests/conftest.py`
(which does): `python -m pytest --noconftest tests/test_torch_port_cmgan.py
-m card`.
"""

import math
import os

import numpy as np
import pytest
import torch

import cmgan_reference as ref
from idccrn_vae_torch.eval.enhance import CmganEnhancer
from idccrn_vae_torch.models.cmgan import TSCNet
from idccrn_vae_torch.ops import rel_attention as ra
from idccrn_vae_torch.ops.stft import istft, stft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cores per xdist worker, as tests/torch_port_util.py caps them
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

C, HEADS, TSCBS, MAXPOS, NFFT, HOP = 8, 2, 2, 12, 64, 16
BINS = NFFT // 2 + 1
LENGTHS = (700, 413, 999, 256, 530)


def weights(seed: int = 3) -> dict:
    """A state dict of the reference's layout drawn from `seed`."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in ref.layout(ref.TSCNet(C, BINS, TSCBS, HEADS,
                                                   MAXPOS)):
        if init[0] == "uniform":
            b = 1 / math.sqrt(init[1])
            t = (torch.rand(shape, generator=g) * 2 - 1) * b
        elif init[0] == "range":
            t = init[1] + torch.rand(shape, generator=g) * (init[2] - init[1])
        elif init[0] == "normal":
            t = torch.randn(shape, generator=g)
        else:
            t = torch.full(shape, float(init[1]))
        out[name] = t
    return out


def reference(sd: dict) -> ref.TSCNet:
    model = ref.TSCNet(C, BINS, TSCBS, HEADS, MAXPOS).eval()
    model.load_state_dict(sd)
    return model


def enhancer(sd: dict, compute: str, **kw) -> CmganEnhancer:
    return CmganEnhancer(sd, num_channel=C, num_tscb=TSCBS, heads=HEADS,
                         max_pos_emb=MAXPOS, n_fft=NFFT, hop=HOP,
                         compute=compute, bucket_frames=10, cut_len=10**6,
                         device="cpu", **kw)


def utterances(lengths=LENGTHS, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]


def wanted(sd: dict, wavs):
    model = reference(sd)
    return [ref.enhance(torch.from_numpy(w), model, NFFT, HOP,
                        cut_len=10**6).numpy() for w in wavs]


def gap(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("compute,tol", [("f32", 1e-5), ("bf16", 0.02)])
def test_enhancer_against_the_reference(compute, tol):
    """A padded batch of mixed lengths (two buckets) against the
    reference's enhancement of each utterance alone."""
    sd, wavs = weights(), utterances()
    got = enhancer(sd, compute).enhance_utterances(wavs, batch_size=3)
    for g, w, want in zip(got, wavs, wanted(sd, wavs)):
        assert g.shape == w.shape
        assert gap(g, want) < tol


def test_padded_rows_equal_each_utterance_alone():
    """Each row of one padded batch equals its utterance enhanced alone in
    a bucket of its own, to float32 rounding."""
    sd, wavs = weights(5), utterances(seed=1)
    enh = enhancer(sd, "f32")
    together = enh.enhance_utterances(wavs, batch_size=len(wavs))
    for w, g in zip(wavs, together):
        alone = enh.enhance_utterances([w], batch_size=1)[0]
        assert gap(g, alone) < 1e-6


def test_relative_term_and_masks_matter():
    """The controls are a thousand times the float32 tolerance off or
    more: the relative term left out (every embedding zero: 1.6-2.5%
    here), and a batch whose rows are not masked (its lengths taken as
    the bucket's; 5-40% for every row shorter than the bucket's
    longest)."""
    sd, wavs = weights(), utterances()
    want = wanted(sd, wavs)
    no_emb = {k: torch.zeros_like(v) if k.endswith("rel_pos_emb.weight")
              else v for k, v in sd.items()}
    no_rel = enhancer(no_emb, "f32").enhance_utterances(wavs, 5)
    assert min(gap(g, w) for g, w in zip(no_rel, want)) > 0.01
    enh = enhancer(sd, "f32")
    enh._run = lambda wav, generator, lengths: enh.forward(wav)
    unmasked = enh.enhance_utterances(wavs, 5)
    shorter = [gap(g, w) for g, w, x in zip(unmasked, want, wavs)
               if len(x) < max(LENGTHS)]
    assert min(shorter) > 0.01


def test_padding_rule_is_evaluation_py():
    """A row's first ceil(L / hop) + 1 STFT frames are those upstream
    takes of the utterance alone (padded with its own first samples to a
    multiple of the hop, reflected at its end)."""
    enh = enhancer(weights(), "f32")
    for n in (700, 704, 417):
        w = utterances((n,))[0]
        row = np.zeros(enh.bucket_length(n), np.float32)
        enh._fill(row, w)
        frames = enh._frames(n)
        padded = (frames - 1) * HOP
        alone = np.concatenate([w, w[: padded - n]])
        want = torch.stft(torch.from_numpy(alone), NFFT, HOP,
                          window=torch.hamming_window(NFFT),
                          return_complex=True)
        got = stft(torch.from_numpy(row)[None], NFFT, HOP, NFFT,
                   window="hamming")[0]
        assert want.shape[-1] == frames
        assert torch.allclose(got[:, :frames], torch.view_as_real(want),
                              atol=1e-5)
        assert len(row) >= padded + NFFT // 2
        assert (len(row) // HOP + 1) % 10 == 0


def test_counters_and_the_cut_len():
    sd, wavs = weights(), utterances()
    enh = enhancer(sd, "f32")
    enh.enhance_utterances(wavs, batch_size=2)
    f2 = BINS // 2 + 1
    frames = [-(-n // HOP) + 1 for n in LENGTHS]
    c = enh.counters
    assert c["batches"] == 3 and c["rows"] == 5
    assert c["real_frames"] == sum(frames)
    assert c["attn_scores"] == TSCBS * HEADS * sum(
        f2 * t * t + t * f2 * f2 for t in frames)
    assert 0 < c["real_frames"] < c["padded_frames"]
    short = enhancer(sd, "f32")
    short.cut_len = 480
    with pytest.raises(ValueError, match="cut_len"):
        short.enhance_utterances([np.zeros(481, np.float32)])
    short.enhance_utterances([np.full(480, 0.1, np.float32)])


@pytest.mark.parametrize("masked", [False, True])
def test_attention_past_max_pos_emb(masked):
    """The plain path against the reference's per-head einsums, at n = 40
    > max_pos_emb = 12, with and without key lengths (the reference then
    runs each row alone on its first `length` keys, as upstream runs an
    utterance unpadded)."""
    torch.manual_seed(0)
    att = ref.Attention(C, HEADS, C // HEADS, max_pos_emb=MAXPOS).eval()
    with torch.no_grad():
        att.rel_pos_emb.weight.normal_()
    x = torch.randn(3, 40, C)
    q, k, v = att.to_q(x), *att.to_kv(x).chunk(2, dim=-1)
    q, k, v = (t.view(3, 40, HEADS, -1).transpose(1, 2) for t in (q, k, v))
    lens = torch.tensor([40, 17, 1]) if masked else None
    got = ra.rel_attention(q, k, v, att.rel_pos_emb.weight, lens)
    got = att.to_out(got.transpose(1, 2).reshape(3, 40, C))
    with torch.no_grad():
        for r in range(3):
            n = 40 if lens is None else int(lens[r])
            # rows past the length attend to the real keys alone: the
            # reference's answer for them is not upstream's, so compare
            # the real ones
            want = att(x[r: r + 1, :n])[0]
            assert torch.allclose(got[r, :n], want, atol=1e-5)


@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_stft_and_istft_against_torch(window):
    torch.manual_seed(0)
    x = torch.randn(2, 4000)
    w = (torch.hann_window if window == "hann" else torch.hamming_window)(400)
    want = torch.stft(x, 400, 100, window=w, return_complex=True)
    got = stft(x, 400, 100, 400, window=window)
    assert torch.allclose(got, torch.view_as_real(want), atol=1e-4)
    back = istft(got, 400, 100, 400, window=window)
    assert torch.allclose(back, torch.istft(want, 400, 100, window=w),
                          atol=1e-5)


def test_istft_of_real_frames():
    """`istft(frames=...)`: each row's samples are torch.istft's of its
    real frames alone, where those frames reach."""
    torch.manual_seed(1)
    spec = torch.view_as_real(torch.stft(
        torch.randn(2, 3200), NFFT, HOP, window=torch.hamming_window(NFFT),
        return_complex=True)) * torch.rand(1, BINS, 1, 1)
    frames = torch.tensor([201, 120])
    got = istft(spec, NFFT, HOP, NFFT, window="hamming", frames=frames)
    for r, t in enumerate(frames.tolist()):
        want = torch.istft(torch.view_as_complex(spec[r, :, :t].contiguous()),
                           NFFT, HOP, window=torch.hamming_window(NFFT))
        assert torch.allclose(got[r, : want.shape[-1]], want, atol=1e-5)


def test_parameter_names_are_upstreams():
    port = TSCNet(C, BINS, TSCBS, HEADS, MAXPOS).state_dict()
    want = ref.TSCNet(C, BINS, TSCBS, HEADS, MAXPOS).state_dict()
    assert [(k, v.shape) for k, v in port.items()] \
        == [(k, v.shape) for k, v in want.items()]
    full = TSCNet(device="meta").state_dict()
    for name, shape in [
            ("dense_encoder.conv_1.0.weight", (64, 3, 1, 1)),
            ("dense_encoder.dilated_dense.conv4.weight", (64, 256, 2, 3)),
            ("dense_encoder.conv_2.1.weight", (64,)),
            ("TSCB_4.time_conformer.attn.fn.rel_pos_emb.weight", (1025, 16)),
            ("TSCB_1.freq_conformer.attn.fn.to_kv.weight", (128, 64)),
            ("TSCB_1.time_conformer.ff1.fn.fn.net.3.weight", (64, 256)),
            ("TSCB_2.time_conformer.conv.net.4.conv.weight", (128, 1, 31)),
            ("TSCB_2.time_conformer.conv.net.5.running_var", (128,)),
            ("TSCB_3.freq_conformer.post_norm.bias", (64,)),
            ("mask_decoder.sub_pixel.conv.weight", (128, 64, 1, 3)),
            ("mask_decoder.prelu_out.weight", (201,)),
            ("complex_decoder.conv.weight", (2, 64, 1, 2))]:
        assert tuple(full[name].shape) == shape, name
    n = sum(v.numel() for k, v in full.items()
            if not k.endswith("num_batches_tracked"))
    assert 1.8e6 < n < 1.9e6


def test_reference_copies_are_equal():
    with open(os.path.join(ROOT, "tests", "cmgan_reference.py"), "rb") as f:
        here = f.read()
    with open(os.path.join(ROOT, "benchmark", "reference", "cmgan.py"),
              "rb") as f:
        assert f.read() == here


@pytest.mark.card
@pytest.mark.parametrize("rows,n,masked,maxpos", [
    (808, 2600, True, 512), (8 * 2600, 101, False, 512),
    (5, 200, True, 12)])
def test_kernel_against_the_plain_path_on_the_card(rows, n, masked, maxpos):
    """The published shapes (q, k, v strided as the model makes them), and
    a short table, whose clip every tile of both signs passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(rows + n)
    qkv = torch.randn(rows, n, 3, 4, 16, device=dev, generator=g).to(
        torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    emb = torch.randn(2 * maxpos + 1, 16, device=dev, generator=g).to(
        torch.bfloat16)
    lens = None
    if masked:
        lens = torch.randint(1, n + 1, (rows,), device=dev, generator=g)
        lens[0], lens[1] = n, 1
    launches = ra.COUNTERS["kernel_launches"]
    got = ra.rel_attention(q, k, v, emb, lens)
    assert ra.COUNTERS["kernel_launches"] == launches + 1
    want = ra.rel_attention_plain(q, k, v, emb, lens, block=64)
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert err < 1e-2


def test_flops_count_is_flop_counter_modes():
    """`benchmark/cmgan_flops.py` counts what FlopCounterMode counts of
    the reference's products on one utterance of 30 frames."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import cmgan_flops

    config = {"model": {"num_channel": C, "heads": HEADS, "num_tscb": TSCBS,
                        "conv_kernel_size": 31, "max_pos_emb": MAXPOS},
              "stft": {"n_fft": NFFT, "hop": HOP}}
    model = reference(weights())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(1, 2, 30, BINS))
    assert counter.get_total_flops() == \
        cmgan_flops.utterance_flops(config, 30)["total"]
