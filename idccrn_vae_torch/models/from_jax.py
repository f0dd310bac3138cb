"""Weight bridge: JAX variable trees -> the port's modules.

`load_jax_variables(module, variables)` takes a ``{"params", "stats"}``
tree as the JAX package's `.init` builds it (`NsvaeEncoder`,
`VaeEncoder`, `VaeDecoder`, `SupervisedDccrn`, `LegacyDccrn`,
`Discriminator`), with
numpy leaves, and fills the port module's parameters and
buffers. The port's names are the reference's state_dict names, so this
is the inverse of the JAX package's `models/torch_import.py`:

  encoder[i].conv.wr (kh,kw,Ci,Co)   -> encoders.{i}.conv.conv_re.weight (Co,Ci,kh,kw)
  decoder[i].conv.wr (kh,kw,Ci,Co)   -> decoders.{i}.transconv.tconv_re.weight (Ci,Co,kh,kw)
  encoder[i].bn.* / stats mean_r ... -> encoders.{i}.bn.* / running_mean_real ...
  encoder[i].prelu ()                -> encoders.{i}.prelu.weight (1,)
  lstm.re[k].w_ih (In,4H)            -> lstms.0.lstm_re.weight_ih_l{k} (4H,In)
  lstm[k].w_ih (In,4H) (real LSTM)   -> lstms.0.weight_ih_l{k} (4H,In)
  dense.wr (I,O)                     -> dense.linear_read.weight (O,I)
  speech_heads.mean.wr (I,O)         -> speech_dense_mean.linear_read.weight (O,I)
  heads.mean.wr (I,O)                -> dense_mean.linear_read.weight (O,I)

A supervised / legacy DCCRN's names carry its module's `prefix`
(``std_DCCRN.`` / ``DCCRN.``), as the reference's do.

The BN step counter `count` is not in the state_dict (the reference's
names hold none); it goes into each ComplexBatchNorm's `count` buffer,
so a model initialised or warmed in JAX keeps the JAX copy rule (the
first train batch replaces the running statistics only while
count == 0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from idccrn_vae_torch.models.modules import BN_STATS, ComplexBatchNorm

_BN_PARAMS = ("gamma_rr", "gamma_ri", "gamma_ii", "beta_r", "beta_i")
_CONV_PERM = (3, 2, 0, 1)   # (kh, kw, Ci, Co) -> (Co, Ci, kh, kw)
_TCONV_PERM = (2, 3, 0, 1)  # (kh, kw, Ci, Co) -> (Ci, Co, kh, kw)


def _dense(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.linear_read.weight"] = np.asarray(p["wr"]).T
    out[f"{prefix}.linear_imag.weight"] = np.asarray(p["wi"]).T
    out[f"{prefix}.linear_read.bias"] = p["br"]
    out[f"{prefix}.linear_imag.bias"] = p["bi"]


def _stages(out: dict, prefix: str, params: list, stats: list,
            transposed: bool) -> None:
    conv, re, im, perm = (("transconv", "tconv_re", "tconv_im", _TCONV_PERM)
                          if transposed else
                          ("conv", "conv_re", "conv_im", _CONV_PERM))
    for i, (p, s) in enumerate(zip(params, stats)):
        pre = f"{prefix}.{i}"
        c = p["conv"]
        out[f"{pre}.{conv}.{re}.weight"] = np.transpose(c["wr"], perm)
        out[f"{pre}.{conv}.{im}.weight"] = np.transpose(c["wi"], perm)
        out[f"{pre}.{conv}.{re}.bias"] = c["br"]
        out[f"{pre}.{conv}.{im}.bias"] = c["bi"]
        for k in _BN_PARAMS:
            out[f"{pre}.bn.{k}"] = p["bn"][k]
        for k, name in BN_STATS.items():
            out[f"{pre}.bn.{name}"] = s[k]
        out[f"{pre}.prelu.weight"] = p["prelu"]


def _real_lstm(out: dict, prefix: str, layers: list) -> None:
    for k, layer in enumerate(layers):
        out[f"{prefix}.weight_ih_l{k}"] = np.asarray(layer["w_ih"]).T
        out[f"{prefix}.weight_hh_l{k}"] = np.asarray(layer["w_hh"]).T
        out[f"{prefix}.bias_ih_l{k}"] = layer["b_ih"]
        out[f"{prefix}.bias_hh_l{k}"] = layer["b_hh"]


def _lstm(out: dict, prefix: str, p) -> None:
    """A complex LSTM ({"re", "im"}) or, the discriminator's, a real one
    (a list of layers)."""
    if isinstance(p, (list, tuple)):
        _real_lstm(out, prefix, p)
        return
    for part in ("re", "im"):
        _real_lstm(out, f"{prefix}.lstm_{part}", p[part])


def jax_to_state_dict(variables: dict,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX {"params", "stats"} tree -> arrays under the port's names,
    each preceded by `prefix` and a dot when `prefix` is given."""
    params, stats = variables["params"], variables["stats"]
    out: Dict[str, np.ndarray] = {}
    if "encoder" in params:
        _stages(out, "encoders", params["encoder"], stats["encoder"], False)
    if "decoder" in params:
        _stages(out, "decoders", params["decoder"], stats["decoder"], True)
    if "lstm" in params:
        _lstm(out, "lstms.0", params["lstm"])
    if "dense" in params:
        _dense(out, "dense", params["dense"])
    for group in ("speech", "noise"):
        for head, p in params.get(f"{group}_heads", {}).items():
            _dense(out, f"{group}_dense_{head}", p)
    for head, p in params.get("heads", {}).items():
        _dense(out, f"dense_{head}", p)
    pre = f"{prefix}." if prefix else ""
    return {pre + k: np.ascontiguousarray(v, np.float32)
            for k, v in out.items()}


def jax_to_port_tensors(variables: dict,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """`jax_to_state_dict` as CPU tensors in the port modules' shapes
    (BN statistics (C,) -> (1, C, 1, 1), PReLU () -> (1,)): a state_dict
    that loads without the module at hand (a checkpoint's best.pt)."""
    stats = set(BN_STATS.values())
    out = {}
    for name, arr in jax_to_state_dict(variables, prefix).items():
        t = torch.from_numpy(arr)
        if name.rsplit(".", 1)[-1] in stats:
            t = t.reshape(1, -1, 1, 1)
        elif name.endswith(".prelu.weight"):
            t = t.reshape(1)
        out[name] = t
    return out


def jax_bn_counts(variables: dict, prefix: str = "") -> Dict[str, int]:
    """The BN step counters of a JAX variable tree, by the port module
    name of their ComplexBatchNorm (``encoders.{i}.bn`` ...)."""
    pre = f"{prefix}." if prefix else ""
    out = {}
    for group, name in (("encoder", "encoders"), ("decoder", "decoders")):
        for i, s in enumerate(variables["stats"].get(group, [])):
            if "count" in s:
                out[f"{pre}{name}.{i}.bn"] = int(np.asarray(s["count"]))
    return out


def load_jax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Fill `module`'s parameters and buffers from JAX variables, in place.

    Every parameter and persistent buffer must be covered and every
    array must fit its tensor's size; leaves are reshaped to the port's
    shapes (BN statistics (C,) -> (1, C, 1, 1), PReLU () -> (1,)). The
    BN step counters come from the stats' `count` leaves.
    """
    prefix = getattr(module, "prefix", "")
    arrays = jax_to_state_dict(variables, prefix)
    target = module.state_dict()
    missing = sorted(set(target) - set(arrays))
    extra = sorted(set(arrays) - set(target))
    if missing or extra:
        raise KeyError(f"JAX variables do not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {extra}")
    loaded = {}
    for name, arr in arrays.items():
        shape = target[name].shape
        if arr.size != target[name].numel():
            raise ValueError(f"{name}: JAX leaf of shape {arr.shape} does "
                             f"not fit {tuple(shape)}")
        loaded[name] = torch.tensor(arr).reshape(shape)
    module.load_state_dict(loaded, strict=True)
    counts = jax_bn_counts(variables, prefix)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, ComplexBatchNorm) and name in counts:
                m.count.fill_(counts[name])
    return module
