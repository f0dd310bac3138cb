"""Ahead-of-time export of the serving programs (torch.export).

The port of `idccrn_vae_tpu/eval/export.py`. The whole serving program
(STFT -> NSVAE encoder -> latent -> decoder -> ISTFT, or the supervised
DCCRN, weights as constants) exports to one `.pt2` file that
`torch.export.load` runs without this package's models, the checkpoint
or the config:

    prog = export_serving(serving_fn_nsvae(enhancer), length, device)
    save_artifacts(dir, {length: prog}, meta)   # enhance.pt2 + meta.json
    call, meta = load_artifact(dir)             # no model code needed
    out = call(wav, generator=torch.Generator().manual_seed(0))

The batch dimension is symbolic (`torch.export.Dim`, one artifact
serves any batch); the utterance length is fixed per artifact, and
several lengths export as buckets. The program is traced on the device
it is exported on; running it on another device is an explicit
`load_artifact(dir, device=...)`, which moves it with
`torch.export.passes.move_to_device_pass`.

Randomness: the port's latent draws come from explicit generators,
which a graph cannot take, so the NSVAE program takes its standard
normal draws as inputs, in place of the JAX artifact's raw key:
(wav[b, L] f32, eps_r, eps_i[, noise_eps_r, noise_eps_i]), each eps
(b, num_samples, L // hop + 1, zdim); the noise latent's pair only for a
dual-latent encoder. `load_artifact`'s call draws them from a generator
when it is not given them. The supervised program takes wav only.

The streaming artifact exports `StreamingEnhancer`'s chunk step with the
carried state as a flat list of tensors (`state_spec` in
stream_meta.json), so a consumer needs neither this package nor the
state's NamedTuple: the initial state is zeros of the recorded shapes.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

ARTIFACT_NAME = "enhance.pt2"
META_NAME = "meta.json"
STREAM_ARTIFACT_NAME = "stream_step.pt2"
STREAM_META_NAME = "stream_meta.json"
EXAMPLE_BATCH = 2  # traced batch; the exported dim is symbolic, b >= 1


class ServingFn:
    """A serving program and the shapes of its inputs: call(wav, *eps),
    with `eps_pairs` (eps_r, eps_i) pairs of shape (b, num_samples,
    L // hop + 1, zdim) after wav."""

    def __init__(self, call: Callable, eps_pairs: int = 0,
                 num_samples: int = 1, zdim: int = 0, hop: int = 1):
        self.call = call
        self.eps_pairs = eps_pairs
        self.num_samples = num_samples
        self.zdim = zdim
        self.hop = hop

    def eps_shape(self, b: int, length: int) -> Tuple[int, ...]:
        return (b, self.num_samples, length // self.hop + 1, self.zdim)

    def draw_eps(self, b: int, length: int, generator: torch.Generator,
                 device) -> List[torch.Tensor]:
        """Standard normal draws for the eps inputs, from `generator` (on
        its own device) and then moved to `device`."""
        shape = self.eps_shape(b, length)
        return [torch.randn(shape, generator=generator).to(device)
                for _ in range(2 * self.eps_pairs)]

    def meta(self) -> dict:
        return {"eps_pairs": self.eps_pairs, "num_samples": self.num_samples,
                "zdim": self.zdim, "hop": self.hop}


def serving_fn_nsvae(enhancer) -> ServingFn:
    """Serving program of an `eval.enhance.Enhancer`: (wav, eps...) ->
    enhanced wav. The body is `Enhancer.program`, so the live and the
    exported programs cannot diverge."""
    pairs = 2 if enhancer.enc_cfg.latent_num == 2 else 1

    def call(wav, *eps):
        noise_n = (eps[2], eps[3]) if pairs == 2 else None
        return enhancer.program(wav, noise=(eps[0], eps[1]),
                                noise_n=noise_n)

    return ServingFn(call, pairs, enhancer.num_samples,
                     enhancer.enc_cfg.zdim, enhancer.enc_cfg.stft.hop)


def serving_fn_supervised(model) -> ServingFn:
    """Serving program of a `SupervisedDccrn` (eval mode): wav -> clean."""
    model.eval()
    return ServingFn(lambda wav: model(wav)[0])


class _Program(torch.nn.Module):
    """torch.export exports a module: this one calls `fn`."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serving(serving: ServingFn, length: int, device):
    """torch.export of serving.call at utterance length `length`, traced
    on `device`, with a symbolic batch dimension (b >= 1)."""
    b = torch.export.Dim("b", min=1)
    ex = EXAMPLE_BATCH
    args = (torch.zeros(ex, length, device=device),
            *serving.draw_eps(ex, length, torch.Generator().manual_seed(0),
                              device))
    with torch.no_grad():
        # forward(*args) takes one varargs tuple
        return torch.export.export(
            _Program(serving.call), args,
            dynamic_shapes=(tuple({0: b} for _ in args),))


def bucketed_call(programs: Sequence[Tuple[int, Callable]],
                  serving: ServingFn, device) -> Callable:
    """call(wav, *eps, generator=None) over programs [(length, fn)]: the
    wav (b, n), numpy or tensor, is zero-padded to the smallest covering
    length and the output trimmed back to n, as the live Enhancer's
    bucketing does. Without eps the draws come from `generator` (a CPU
    generator seeded 0 when None) at that length's shape; given eps must
    have it. Longer input raises: window it (cli/run_artifact does)."""
    programs = sorted(programs, key=lambda p: p[0])
    max_len = programs[-1][0]

    def call(wav, *eps, generator: Optional[torch.Generator] = None):
        wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
        n = wav.shape[1]
        if n > max_len:
            raise ValueError(
                f"input length {n} exceeds the largest artifact bucket "
                f"{max_len}; window the signal (cli/run_artifact does)")
        length, fn = next(p for p in programs if p[0] >= n)
        wav = torch.nn.functional.pad(wav, (0, length - n))
        if serving.eps_pairs and not eps:
            gen = (torch.Generator().manual_seed(0) if generator is None
                   else generator)
            eps = serving.draw_eps(wav.shape[0], length, gen, device)
        with torch.no_grad():
            out = fn(wav, *eps)
        return out[:, :n]

    return call


def save_artifacts(out_dir: str, exports: Dict[int, object],
                   serving: ServingFn, device, meta: dict) -> str:
    """One `.pt2` per bucket length ({L: ExportedProgram}) plus meta.json.
    meta['length'] is the largest bucket (the windowing width for longer
    utterances); meta['artifact'] names its file."""
    os.makedirs(out_dir, exist_ok=True)
    meta = dict(meta)
    buckets = []
    for length in sorted(exports):
        name = (ARTIFACT_NAME if len(exports) == 1
                else f"enhance_{length}.pt2")
        torch.export.save(exports[length], os.path.join(out_dir, name))
        buckets.append({"length": int(length), "artifact": name})
    meta.update(serving.meta())
    meta["buckets"] = buckets
    meta["length"] = buckets[-1]["length"]
    meta["artifact"] = buckets[-1]["artifact"]
    eps = ", eps_r, eps_i" + (", noise_eps_r, noise_eps_i"
                              if serving.eps_pairs == 2 else "")
    meta["calling_convention"] = (
        f"(wav[b, length] f32{eps if serving.eps_pairs else ''}) -> "
        "out[b, length]; each eps f32 (b, num_samples, length // hop + 1, "
        "zdim) standard normal")
    meta["device"] = str(torch.device(device))
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return os.path.join(out_dir, buckets[-1]["artifact"])


def _load(path: str, exported_on: str, device):
    """An ExportedProgram's module, moved to `device` when it names
    another device than the one it was exported on."""
    from torch.export.passes import move_to_device_pass

    prog = torch.export.load(path)
    if device is not None and torch.device(device) != torch.device(
            exported_on):
        prog = move_to_device_pass(prog, torch.device(device))
    return prog.module()


def load_artifact(artifact_dir: str, device=None):
    """(call, meta): call(wav, *eps, generator=None) -> enhanced wavs (see
    `bucketed_call`), on the device the artifact was exported on, or on
    `device` (an explicit move). Needs no model code, config or
    checkpoint."""
    with open(os.path.join(artifact_dir, META_NAME)) as f:
        meta = json.load(f)
    run_on = torch.device(meta["device"] if device is None else device)
    programs = [(int(b["length"]),
                 _load(os.path.join(artifact_dir, b["artifact"]),
                       meta["device"], run_on))
                for b in meta["buckets"]]
    serving = ServingFn(None, meta.get("eps_pairs", 0),
                        meta.get("num_samples", 1), meta.get("zdim", 0),
                        meta.get("hop", 1))
    return bucketed_call(programs, serving, run_on), meta


# ------------------------------------------------------------- streaming


def export_streaming(streamer, batch: int = 1):
    """Export a StreamingEnhancer's chunk step, specialised to `batch`,
    on the streamer's device. The program maps (state: list of tensors,
    chunk (batch, chunk_samples) f32) -> (out (batch, chunk_samples),
    new state list). Returns (exported, state_spec), state_spec =
    [[shape, dtype name], ...]."""
    flat, spec = pytree.tree_flatten(streamer.init_state(batch))

    def step(state: List[torch.Tensor], chunk: torch.Tensor):
        out, new = streamer._chunk_step(pytree.tree_unflatten(state, spec),
                                        chunk)
        return out, pytree.tree_flatten(new)[0]

    chunk = torch.zeros(batch, streamer.chunk_samples,
                        device=streamer.device)
    with torch.no_grad():
        exported = torch.export.export(_Program(step), (flat, chunk))
    state_spec = [[list(t.shape), str(t.dtype).replace("torch.", "")]
                  for t in flat]
    return exported, state_spec


def save_streaming_artifact(out_dir: str, exported, state_spec,
                            device, meta: dict) -> str:
    """The streaming meta lives in its own file, so an offline and a
    streaming export of one model can share an artifact dir."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, STREAM_ARTIFACT_NAME)
    torch.export.save(exported, path)
    meta = dict(meta)
    meta["artifact"] = STREAM_ARTIFACT_NAME
    meta["state_spec"] = state_spec
    meta["calling_convention"] = (
        "(state: [tensors per state_spec], chunk[batch, chunk_samples] "
        "f32) -> (out[batch, chunk_samples], new_state)")
    meta["device"] = str(torch.device(device))
    with open(os.path.join(out_dir, STREAM_META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_streaming_artifact(artifact_dir: str, device=None):
    """(step, init_state, meta): state = init_state(); out, state =
    step(state, chunk). On the exported device, or moved to `device`."""
    with open(os.path.join(artifact_dir, STREAM_META_NAME)) as f:
        meta = json.load(f)
    run_on = torch.device(meta["device"] if device is None else device)
    program = _load(os.path.join(artifact_dir, meta["artifact"]),
                    meta["device"], run_on)

    def init_state() -> List[torch.Tensor]:
        return [torch.zeros(shape, dtype=getattr(torch, dtype),
                            device=run_on)
                for shape, dtype in meta["state_spec"]]

    def step(state, chunk):
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=run_on)
        with torch.no_grad():
            return program(state, chunk)

    return step, init_state, meta
