"""The port's config mirror against the JAX package's config."""

import itertools

import pytest
import torch

from idccrn_vae_tpu.models import config as jcfg
from idccrn_vae_torch.models import config as tcfg
import torch_port_util  # noqa: F401  (caps torch's threads)

CHANNEL_MODES = ("normal", "double", "adapt")
SKIP_MODES = ("real", "none", "zero", "prob", "runtime")


@pytest.mark.parametrize("channel_mode,skip_mode",
                         list(itertools.product(CHANNEL_MODES, SKIP_MODES)))
def test_plans_match_jax(channel_mode, skip_mode):
    for skip_to_use in ((0, 1, 2, 3, 4, 5), (0, 2, 5)):
        fields = dict(channel_mode=channel_mode, skip_mode=skip_mode,
                      skip_to_use=skip_to_use)
        j, t = jcfg.DccrnConfig(**fields), tcfg.DccrnConfig(**fields)
        assert tcfg.encoder_plan(t) == jcfg.encoder_plan(j)
        assert tcfg.decoder_plan(t) == jcfg.decoder_plan(j)
        assert tcfg.freq_sizes(t) == jcfg.freq_sizes(j)
        assert tcfg.bottleneck_dims(t) == jcfg.bottleneck_dims(j)
        assert t.num_stages == j.num_stages
        assert t.decoder_channels == j.decoder_channels


def test_fields_and_defaults_match_jax():
    import dataclasses

    j, t = jcfg.DccrnConfig(), tcfg.DccrnConfig()
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for n in names:
        if n != "stft":
            assert getattr(t, n) == getattr(j, n), n
    assert dataclasses.asdict(t.stft) == dataclasses.asdict(j.stft)
    assert t.stft.freq_bins == j.stft.freq_bins == 257
    assert tcfg.bottleneck_dims(t) == (256, 5)


def test_compute_dtype():
    """int8 serves: its unquantized operands ride bf16, its convs
    quantize, and training refuses it with the JAX package's error."""
    assert tcfg.DccrnConfig(compute="f32").compute_dtype == torch.float32
    assert tcfg.DccrnConfig(compute="bf16").compute_dtype == torch.bfloat16
    assert tcfg.DccrnConfig(compute="int8").compute_dtype == torch.bfloat16
    for compute in ("f32", "bf16", "int8"):
        t, j = (tcfg.DccrnConfig(compute=compute),
                jcfg.DccrnConfig(compute=compute))
        assert t.conv_quant == j.conv_quant == (compute == "int8")
        if compute != "int8":
            t.reject_int8_training("Trainer")
    with pytest.raises(ValueError) as terr:
        tcfg.DccrnConfig(compute="int8").reject_int8_training("Trainer")
    with pytest.raises(ValueError) as jerr:
        jcfg.DccrnConfig(compute="int8").reject_int8_training("Trainer")
    assert str(terr.value) == str(jerr.value)
