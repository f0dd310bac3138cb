"""The system under test, built from a configuration file: the port's
`Enhancer`, `StreamingEnhancer` and `PretrainTrainer`, and the weight
layouts the benchmark draws for them.

A configuration file holds the model's geometry ("model", "stft") and
one block per use: "serve" (precision, out-type, latent), "train" (the
CVAE recipe) and "stream".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.model import Geometry, decoder_layout, encoder_layout


def port_configs(config: dict, use: str, **override):
    """(encoder DccrnConfig, decoder DccrnConfig) of `use` ("serve",
    "train" or "stream"); `override` replaces DccrnConfig fields of
    both."""
    from idccrn_vae_torch.models.config import DccrnConfig, StftConfig

    m, u = config["model"], config[use]
    cfg = DccrnConfig(
        stft=StftConfig(**config["stft"]),
        encoder_channels=tuple(m["encoder_channels"]),
        kernel=tuple(m["kernel"]), stride=tuple(m["stride"]),
        freq_pad=m["freq_pad"], causal=m["causal"],
        lstm_layers=m["lstm_layers"], zdim=m["zdim"],
        skip_to_use=tuple(m["skip_to_use"]), latent="sliced",
        skip_mode=u["skip_mode"], compute=u.get("compute", "f32"))
    cfg = dataclasses.replace(cfg, **override)
    if use == "train":
        return cfg, cfg
    enc = dataclasses.replace(cfg, latent_num=m["latent_num"],
                              channel_mode=m["channel_mode"])
    return enc, cfg


def layouts(config: dict, use: str):
    """Weight layouts: the encoder, the (speech) decoder and, for a
    two-latent model served, the noise decoder.

    A configuration's "weights" block may set "decoder_out_beta": [lo,
    hi], the range of the last decoder stage's BN offsets (beta_r,
    beta_i; zero by default)."""
    geo = Geometry.of(config)
    m = config["model"]
    if use == "train":
        return [encoder_layout(geo), decoder_layout(geo)]
    enc = encoder_layout(geo, m["latent_num"], m["channel_mode"] == "double")
    dec = decoder_layout(geo)
    beta = config.get("weights", {}).get("decoder_out_beta")
    if beta:
        last = f"decoders.{geo.stages - 1}.bn.beta_"
        dec = [(n, shape, ("range", *beta) if n.startswith(last) else init)
               for n, shape, init in dec]
    decoders = 2 if use == "serve" and m["latent_num"] == 2 else 1
    return [enc] + [dec] * decoders


def enhancer(config: dict, weights, num_samples: int, device, **override):
    from idccrn_vae_torch.eval.enhance import Enhancer

    enc_cfg, dec_cfg = port_configs(config, "serve", **override)
    s = config["serve"]
    return Enhancer(enc_cfg, dec_cfg, *weights, num_samples=num_samples,
                    outtype=s["outtype"], latent_to_use=s["latent_to_use"],
                    pad_mode=s["pad_mode"], device=device)


def streamer(config: dict, weights, chunk_frames: int, device):
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    enc_cfg, dec_cfg = port_configs(config, "stream")
    return StreamingEnhancer(enc_cfg, dec_cfg, *weights,
                             chunk_frames=chunk_frames,
                             pad_mode=config["stream"]["pad_mode"],
                             device=device)


def trainer(config: dict, weights, num_samples: int, device, **override):
    """A PretrainTrainer of the configuration's CVAE recipe, holding
    `weights` (encoder, decoder)."""
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    cfg, _ = port_configs(config, "train", num_samples=num_samples,
                          **override)
    t = config["train"]
    loss = PretrainVaeLoss(
        kl_warm_weights=np.zeros(0, np.float32), kl_weight=t["kl_weight"],
        mi_weight=0.0, recon_loss_type="multiple",
        recon_loss_weight=tuple(t["recon_loss_weight"]),
        num_samples=num_samples, prior_mode="ri_inde")
    tr = PretrainTrainer(cfg, loss, learning_rate=t["lr"],
                         weight_decay=t["weight_decay"], device=device)
    tr.encoder.load_state_dict(weights[0])
    tr.decoder.load_state_dict(weights[1])
    return tr
