"""`flops.py` against FlopCounterMode's count of the port's products at
the tests' width (transposed convs counted FlopCounterMode's way), and
its decoder against `profile_decoder.macs()` at the reference width."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, inputs, programs
from benchmark.reference.model import Geometry
from benchmark.tests.conftest import load_config, tiny_config

torch.set_num_threads(2)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["idccrn_vae_z128", "idccrn_vae_dual_z128"])
@pytest.mark.parametrize("samples", [1, 3])
def test_serve_forward(name, samples):
    config = tiny_config(name)
    weights = inputs.make_weights(programs.layouts(config, "serve"), 5, "cpu")
    enh = programs.enhancer(config, weights, samples, "cpu", compute="f32")
    wav = torch.randn(2, 3900)
    got = counted(lambda: enh.forward(wav, enh.new_generator()))
    assert got == flops.serve_flops(config, 2, 40, samples, tconv="scatter")


@pytest.mark.parametrize("backward", [False, True])
def test_train_step(backward):
    config = tiny_config("idccrn_vae_z128")
    weights = inputs.make_weights(programs.layouts(config, "train"), 2, "cpu")
    tr = programs.trainer(config, weights, 3, "cpu")
    batch = inputs.cut(inputs.segment_pool(
        {"pool_seconds": 1.0, "pool_utterances": 4}, 1, 16000),
        np.array([[0, 0], [1, 100]]), 4000)
    draws = inputs.latent_draws((2, 3, 41, 4), 1, 0, "cpu")
    if backward:
        got = counted(lambda: tr.train_step(batch, None, 0, noise=draws))
        want = flops.train_step_flops(config, 2, 41, 3, tconv="scatter")
    else:
        tr.encoder.train()
        tr.decoder.train()
        with torch.no_grad():
            got = counted(lambda: tr._losses(torch.from_numpy(batch), None,
                                             0.01, noise=draws))
        want = 2 * flops.train_forward_macs(config, 2, 41, 3,
                                            tconv="scatter")[0]
    assert got == want


def test_decoder_against_profile_decoder():
    """At the reference width, the useful transposed-conv count of a
    decoder whose skips run at every row is profile_decoder's."""
    from idccrn_vae_torch.models.config import DccrnConfig
    from idccrn_vae_torch.tools.profile_decoder import macs, stage_shapes

    config = load_config("idccrn_vae_z128")
    geo = Geometry.of(config)
    rows, t = 32, 481
    c, f = geo.bottleneck(False)
    dense = 2 * rows * t * geo.zdim * c * f
    want = sum(macs(rows, f_out, t, cin, cout)[1]
               for _, cin, cout, _, f_out in stage_shapes(DccrnConfig()))
    assert flops.decoder_macs(geo, rows, rows, t) - dense == want


def test_bucket_frames():
    """The pass's batches as `Enhancer._bucketed` forms them."""
    from idccrn_vae_torch.eval.enhance import bucket_pad_length

    lengths = [160000, 159999, 24000, 50000, 96000, 30001]
    got = flops.bucket_frames(lengths, 4, 100, 100)
    s = sorted(lengths)
    want = [(4, bucket_pad_length(max(s[:4]), 100) // 100 + 1),
            (2, bucket_pad_length(max(s[4:]), 100) // 100 + 1)]
    assert got == want
