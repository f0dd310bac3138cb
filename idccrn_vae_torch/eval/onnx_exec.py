"""Minimal ONNX executor for the DNSMOS models, on a torch device.

The reference scores DNSMOS through onnxruntime sessions over small CNN
.onnx files (DNSMOS/dnsmos_local.py:24-25). onnxruntime is on neither
the CPU hosts nor the card's host of this port, so this module runs
those graphs itself (it never imports onnxruntime):

  * a protobuf WIRE-FORMAT parser for the ModelProto subset the models
    use (no onnx/protobuf-codegen dependency; the wire format is stable
    and documented), a copy of the JAX package's;
  * a torch graph runner (`backend="torch"`, the default) for the 17 op
    types the five graphs contain (opset 12): Conv, MatMul, Add, Mul,
    Div, Pow, Sqrt, Log, Max, Relu, MaxPool, ReduceMax, Transpose,
    Reshape, Concat, Slice, Unsqueeze. The float initializers go to the
    device once, when the session is built; the integer ones (Reshape
    shapes, Slice starts/ends/axes/steps) stay host-side Python ints, so
    no node waits on the device. Every node is a torch op on device
    tensors and only the graph outputs come back to the host;
  * the plain numpy executor (`backend="numpy"`, or IDCCRN_ONNX_NUMPY=1
    in the environment): the same ops in numpy on the CPU, the parity
    oracle of the torch runner.

Numerics are float32. On a CUDA device the runner turns TF32 off for its
convolutions and matmuls while it runs (the flags are process-wide, so
every session's graph runs take one lock of this module, one run at a
time), and restores them after.

`InferenceSession` mirrors the onnxruntime calls the scorer makes
(`run(None, {name: array})`).
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from idccrn_vae_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# protobuf wire-format parsing (ModelProto subset)
# ---------------------------------------------------------------------------


def _read_varint(b: bytes, i: int):
    out = 0
    shift = 0
    while True:
        x = b[i]
        i += 1
        out |= (x & 0x7F) << shift
        if not x & 0x80:
            return out, i
        shift += 7


def _fields(b: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(b)
    while i < n:
        tag, i = _read_varint(b, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(b, i)
        elif wt == 2:
            ln, i = _read_varint(b, i)
            v = b[i : i + ln]
            i += ln
        elif wt == 5:
            v = b[i : i + 4]
            i += 4
        elif wt == 1:
            v = b[i : i + 8]
            i += 8
        else:  # pragma: no cover - groups don't appear in ONNX
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 11: np.float64}


def _parse_tensor(b: bytes) -> tuple:
    """TensorProto -> (name, ndarray)."""
    dims: List[int] = []
    dtype = 1
    raw = None
    floats: List[float] = []
    int64s: List[int] = []
    int32s: List[int] = []
    name = ""
    for fn, wt, v in _fields(b):
        if fn == 1:
            if wt == 0:
                dims.append(v)
            else:  # packed
                i = 0
                while i < len(v):
                    x, i = _read_varint(v, i)
                    dims.append(x)
        elif fn == 2:
            dtype = v
        elif fn == 4:
            if wt == 5:
                floats.append(struct.unpack("<f", v)[0])
            else:
                floats.extend(
                    struct.unpack(f"<{len(v) // 4}f", v))
        elif fn == 5:
            if wt == 0:
                int32s.append(v)
            else:
                i = 0
                while i < len(v):
                    x, i = _read_varint(v, i)
                    int32s.append(x)
        elif fn == 7:
            if wt == 0:
                int64s.append(v)
            else:
                i = 0
                while i < len(v):
                    x, i = _read_varint(v, i)
                    int64s.append(x)
        elif fn == 8:
            name = v.decode()
        elif fn == 9:
            raw = v
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    elif int64s:
        # int64 varints are two's-complement encoded in 64 bits
        arr = np.asarray([x - (1 << 64) if x >= (1 << 63) else x
                          for x in int64s], np_dtype)
    elif int32s:
        arr = np.asarray(int32s, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(b: bytes) -> tuple:
    """AttributeProto -> (name, value) for the types the models use."""
    name = ""
    val = None
    ints: List[int] = []
    for fn, wt, v in _fields(b):
        if fn == 1:
            name = v.decode()
        elif fn == 2:  # f
            val = struct.unpack("<f", v)[0]
        elif fn == 3:  # i
            val = v - (1 << 64) if v >= (1 << 63) else v
        elif fn == 4:  # s
            val = v.decode()
        elif fn == 5:  # t
            val = _parse_tensor(v)[1]
        elif fn == 8:  # ints
            if wt == 0:
                ints.append(v)
            else:
                i = 0
                while i < len(v):
                    x, i = _read_varint(v, i)
                    ints.append(x)
    if ints:
        val = [x - (1 << 64) if x >= (1 << 63) else x for x in ints]
    return name, val


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, b: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, object] = {}
        self.op = ""
        for fn, wt, v in _fields(b):
            if fn == 1:
                self.inputs.append(v.decode())
            elif fn == 2:
                self.outputs.append(v.decode())
            elif fn == 4:
                self.op = v.decode()
            elif fn == 5:
                k, val = _parse_attr(v)
                self.attrs[k] = val


def _io_name(b: bytes) -> str:
    for fn, wt, v in _fields(b):
        if fn == 1:
            return v.decode()
    return ""


def parse_model(path: str):
    """ONNX file -> (nodes, initializers, input_names, output_names)."""
    data = open(path, "rb").read()
    graph = None
    for fn, wt, v in _fields(data):
        if fn == 7:
            graph = v
    if graph is None:
        raise ValueError(f"no GraphProto in {path}")
    nodes, inits, ins, outs = [], {}, [], []
    for fn, wt, v in _fields(graph):
        if fn == 1:
            nodes.append(_Node(v))
        elif fn == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif fn == 11:
            ins.append(_io_name(v))
        elif fn == 12:
            outs.append(_io_name(v))
    ins = [n for n in ins if n not in inits]  # graph inputs minus weights
    return nodes, inits, ins, outs




# ---------------------------------------------------------------------------
# numpy ops (NCHW convention, as exported): the plain version
# ---------------------------------------------------------------------------


def _conv_numpy(x, w, b, attrs):
    """Reference numpy Conv (group 1): NCHW x, OIHW w; 1-D or 2-D."""
    if attrs.get("group", 1) != 1:  # pragma: no cover
        raise NotImplementedError("grouped conv")
    strides = attrs.get("strides", [1] * (x.ndim - 2))
    pads = attrs.get("pads", [0] * (2 * (x.ndim - 2)))
    dil = attrs.get("dilations", [1] * (x.ndim - 2))
    n_sp = x.ndim - 2
    pad_width = [(0, 0), (0, 0)] + [
        (pads[i], pads[i + n_sp]) for i in range(n_sp)]
    x = np.pad(x, pad_width)
    if n_sp == 1:  # promote 1-D conv to 2-D
        x = x[..., None]
        w = w[..., None]
        strides = list(strides) + [1]
        dil = list(dil) + [1]
    n, c, h, ww = x.shape
    co, ci, kh, kw = w.shape
    sh, sw = strides
    dh, dw = dil
    oh = (h - (kh - 1) * dh - 1) // sh + 1
    ow = (ww - (kw - 1) * dw - 1) // sw + 1
    # kh*kw accumulated GEMMs: each kernel offset contributes
    # W[:, :, i, j] @ shifted-input (no im2col blowup)
    out = np.zeros((co, n, oh, ow), np.float32)
    for i in range(kh):
        for j in range(kw):
            patch = x[:, :, i * dh : i * dh + oh * sh : sh,
                      j * dw : j * dw + ow * sw : sw]
            out += np.tensordot(w[:, :, i, j], patch, axes=([1], [1]))
    out = np.transpose(out, (1, 0, 2, 3))
    if b is not None:
        out = out + b[None, :, None, None]
    if n_sp == 1:
        out = out[..., 0]
    return np.ascontiguousarray(out, np.float32)


def _maxpool_numpy(x, attrs):
    kh, kw = attrs["kernel_shape"]
    sh, sw = attrs.get("strides", attrs["kernel_shape"])
    pads = attrs.get("pads", [0, 0, 0, 0])
    x = np.pad(x, [(0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])],
               constant_values=-np.inf)
    n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    out = np.full((n, c, oh, ow), -np.inf, x.dtype)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(
                out, x[:, :, i : i + oh * sh : sh, j : j + ow * sw : sw])
    return out


def _slice_args(ndim, starts, ends, axes=None, steps=None):
    """ONNX Slice inputs -> one Python slice per axis, the INT64_MAX (and
    INT64_MIN) sentinels clamped to int32."""
    starts = np.asarray(starts).astype(np.int64)
    ends = np.asarray(ends).astype(np.int64)
    axes = (np.arange(len(starts)) if axes is None
            else np.asarray(axes).astype(np.int64))
    steps = (np.ones(len(starts), np.int64) if steps is None
             else np.asarray(steps).astype(np.int64))
    sl = [slice(None)] * ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        e = min(int(e), np.iinfo(np.int32).max)
        s = max(int(s), -(2**31))
        sl[int(a)] = slice(s, e, int(st))
    return tuple(sl)


def _slice(x, starts, ends, axes=None, steps=None):
    return x[_slice_args(x.ndim, starts, ends, axes, steps)]


def _run_numpy(nodes, env):
    """Execute `nodes` over `env` (name -> ndarray) in numpy."""
    for nd in nodes:
        ins = [env[i] if i else None for i in nd.inputs]
        op = nd.op
        if op == "Conv":
            out = _conv_numpy(ins[0], ins[1],
                              ins[2] if len(ins) > 2 else None, nd.attrs)
        elif op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Pow":
            out = np.power(ins[0], ins[1])
        elif op == "Sqrt":
            out = np.sqrt(ins[0])
        elif op == "Log":
            out = np.log(ins[0])
        elif op == "Max":
            out = ins[0]
            for other in ins[1:]:
                out = np.maximum(out, other)
        elif op == "Relu":
            out = np.maximum(ins[0], 0)
        elif op == "MaxPool":
            out = _maxpool_numpy(ins[0], nd.attrs)
        elif op == "ReduceMax":
            axes = tuple(nd.attrs.get("axes", range(ins[0].ndim)))
            keep = bool(nd.attrs.get("keepdims", 1))
            out = np.max(ins[0], axis=axes, keepdims=keep)
        elif op == "Transpose":
            out = np.transpose(ins[0], nd.attrs.get("perm"))
        elif op == "Reshape":
            out = ins[0].reshape([int(d) for d in ins[1]])
        elif op == "Concat":
            out = np.concatenate(ins, axis=nd.attrs.get("axis", 0))
        elif op == "Slice":
            out = _slice(ins[0], ins[1], ins[2],
                         ins[3] if len(ins) > 3 else None,
                         ins[4] if len(ins) > 4 else None)
        elif op == "Unsqueeze":
            axes = nd.attrs.get("axes")
            if axes is None:
                axes = [int(a) for a in ins[1]]
            out = ins[0]
            for a in sorted(axes):
                out = np.expand_dims(out, a)
        elif op == "Squeeze":
            axes = nd.attrs.get("axes")
            out = np.squeeze(ins[0], axis=tuple(axes) if axes else None)
        elif op == "Identity":
            out = ins[0]
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        else:  # pragma: no cover
            raise NotImplementedError(f"ONNX op {op}")
        for o in nd.outputs:
            env[o] = out
    return env


# ---------------------------------------------------------------------------
# torch ops on device tensors
# ---------------------------------------------------------------------------


def _conv_torch(x, w, b, attrs):
    """Conv (group 1) over device tensors: NC(H)W x, OI(H)W w. ONNX pads
    may be asymmetric; torch pads symmetrically, so an asymmetric pair is
    applied with F.pad first."""
    if attrs.get("group", 1) != 1:  # pragma: no cover
        raise NotImplementedError("grouped conv")
    n_sp = x.ndim - 2
    strides = [int(s) for s in attrs.get("strides", [1] * n_sp)]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * n_sp))]
    dil = [int(d) for d in attrs.get("dilations", [1] * n_sp)]
    begin, end = pads[:n_sp], pads[n_sp:]
    if begin != end:
        flat = []
        for d in reversed(range(n_sp)):
            flat += [begin[d], end[d]]
        x = F.pad(x, flat)
        begin = [0] * n_sp
    conv = F.conv1d if n_sp == 1 else F.conv2d
    return conv(x, w, b, stride=strides, padding=begin, dilation=dil)


def _maxpool_torch(x, attrs):
    kh, kw = (int(k) for k in attrs["kernel_shape"])
    sh, sw = (int(s) for s in attrs.get("strides", attrs["kernel_shape"]))
    pads = [int(p) for p in attrs.get("pads", [0, 0, 0, 0])]
    if any(pads):
        x = F.pad(x, [pads[1], pads[3], pads[0], pads[2]],
                  value=float("-inf"))
    return F.max_pool2d(x, kernel_size=(kh, kw), stride=(sh, sw))


def _host_ints(v) -> List[int]:
    """A shape-like operand as host ints. Initializers are host arrays
    already; a tensor that a node computed is read back once here."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(d) for d in np.asarray(v).reshape(-1)]


def _run_torch(nodes, env):
    """Execute `nodes` over `env` (name -> device tensor, or a host int
    array for an integer initializer) with torch ops."""
    for nd in nodes:
        ins = [env[i] if i else None for i in nd.inputs]
        op = nd.op
        if op == "Conv":
            out = _conv_torch(ins[0], ins[1],
                              ins[2] if len(ins) > 2 else None, nd.attrs)
        elif op == "MatMul":
            out = torch.matmul(ins[0], ins[1])
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Pow":
            out = torch.pow(ins[0], ins[1])
        elif op == "Sqrt":
            out = torch.sqrt(ins[0])
        elif op == "Log":
            out = torch.log(ins[0])
        elif op == "Max":
            out = ins[0]
            for other in ins[1:]:
                out = torch.maximum(out, other)
        elif op == "Relu":
            out = torch.relu(ins[0])
        elif op == "MaxPool":
            out = _maxpool_torch(ins[0], nd.attrs)
        elif op == "ReduceMax":
            axes = tuple(nd.attrs.get("axes", range(ins[0].ndim)))
            keep = bool(nd.attrs.get("keepdims", 1))
            out = torch.amax(ins[0], dim=axes, keepdim=keep)
        elif op == "Transpose":
            perm = nd.attrs.get("perm") or list(range(ins[0].ndim))[::-1]
            out = ins[0].permute(*perm)
        elif op == "Reshape":
            out = ins[0].reshape(_host_ints(ins[1]))
        elif op == "Concat":
            out = torch.cat(ins, dim=nd.attrs.get("axis", 0))
        elif op == "Slice":
            rest = [_host_ints(v) for v in ins[1:]]
            out = ins[0][_slice_args(ins[0].ndim, *rest)]
        elif op == "Unsqueeze":
            axes = nd.attrs.get("axes")
            if axes is None:
                axes = _host_ints(ins[1])
            out = ins[0]
            for a in sorted(axes):
                out = out.unsqueeze(a)
        else:  # pragma: no cover
            raise NotImplementedError(f"ONNX op {op}")
        for o in nd.outputs:
            env[o] = out
    return env


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block, the flags restored after (they are process-wide)."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


# the TF32 flags are process-wide: every torch-backend run, of any session
# in any thread, holds this lock while it has them off
_RUN_LOCK = threading.Lock()


def numpy_forced() -> bool:
    """IDCCRN_ONNX_NUMPY=1 (any non-empty value) selects the numpy
    executor, as in the JAX package."""
    return bool(os.environ.get("IDCCRN_ONNX_NUMPY"))


class InferenceSession:
    """onnxruntime.InferenceSession lookalike.

    backend "torch" (the default): the graph runs on `device`, CUDA
    unless the caller asks for another device (no card and no
    device="cpu" raises before the model file is read). backend
    "numpy", or IDCCRN_ONNX_NUMPY=1: the plain numpy executor on the
    CPU; `device` is then ignored.
    """

    def __init__(self, path: str, device: DeviceLike = None,
                 backend: str = "torch"):
        if backend not in ("torch", "numpy"):
            raise ValueError(f"backend must be 'torch' or 'numpy': {backend}")
        self.backend = "numpy" if numpy_forced() else backend
        self.device = (None if self.backend == "numpy"
                       else resolve_device(device))
        self.nodes, inits, self.input_names, self.output_names = (
            parse_model(path))
        if self.device is None:
            self.inits = inits
        else:
            self.inits = {
                k: (torch.from_numpy(np.array(v, np.float32)).to(self.device)
                    if v.dtype.kind == "f" else _host_ints(v))
                for k, v in inits.items()}

    def run_nodes(self, feeds: Dict[str, np.ndarray]) -> dict:
        """Every value of the graph after one run: the initializers, the
        feeds and each node's output (device tensors on the torch
        backend, ndarrays on the numpy one)."""
        env = dict(self.inits)
        if self.device is None:
            for k, v in feeds.items():
                env[k] = np.asarray(v, np.float32)
            return _run_numpy(self.nodes, env)
        for k, v in feeds.items():
            env[k] = torch.as_tensor(np.asarray(v, np.float32)).to(
                self.device)
        with _RUN_LOCK, torch.inference_mode(), full_f32():
            return _run_torch(self.nodes, env)

    def run(self, output_names: Optional[Sequence[str]],
            feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        env = self.run_nodes(feeds)
        names = output_names or self.output_names
        if self.device is None:
            return [env[n] for n in names]
        return [env[n].cpu().numpy() for n in names]
