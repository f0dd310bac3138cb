"""DNSMOS in the port (eval/onnx_exec.py, eval/dnsmos.py, cli/dnsmos.py)
against the JAX package's on the CPU.

Tolerances:
  * the assets byte for byte; the parsed graphs (nodes, attributes,
    initializers) exactly;
  * the numpy executor and the numpy op primitives against JAX's numpy
    path to 1e-9 (the same float32 arithmetic in the same order);
  * the torch op primitives against JAX's at rtol 1e-4 / atol 1e-5 (the
    JAX package's own torch-vs-numpy bound, tests/test_dnsmos.py:109);
  * each graph's output, the port's torch backend on the CPU against
    JAX's executor, to 1e-5 relative (both take torch's CPU conv; the
    port also runs the elementwise ops, matmuls and reductions in torch);
  * the mel filterbank and features to 1e-9;
  * scores to 1e-5 relative, and the pinned goldens (tests/test_dnsmos.py:
    112-130) to 1e-4.
"""

import csv
import os

import numpy as np
import pytest

from idccrn_vae_tpu.eval import dnsmos as jdnsmos
from idccrn_vae_tpu.eval import onnx_exec as jexec
from idccrn_vae_torch.eval import dnsmos as tdnsmos
from idccrn_vae_torch.eval import onnx_exec as texec
from torch_port_util import FS

GRAPHS = ("DNSMOS/model_v8.onnx", "DNSMOS/sig.onnx", "DNSMOS/bak_ovr.onnx",
          "DNSMOS/sig_bak_ovr.onnx", "pDNSMOS/sig_bak_ovr.onnx")
GOLDENS = {"OVRL_raw": 1.612839, "SIG_raw": 1.693456, "BAK_raw": 2.387266,
           "P808_MOS": 2.182581}
GRAPH_REL = 1e-5
SCORE_REL = 1e-5


def _asset(package_eval_module, rel):
    base = os.path.dirname(os.path.dirname(package_eval_module.__file__))
    return os.path.join(base, "assets", "dnsmos", rel)


def golden_signal(seconds=9.01, fs=FS, seed=42):
    """AM tone + noise (tests/test_dnsmos.py:118-123)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    return (0.4 * np.sin(2 * np.pi * 300 * t)
            * (1 + 0.8 * np.sin(2 * np.pi * 2 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def graph_input(rel, seed=0):
    """A seeded input of the graph's kind: 9.01 s of audio for the
    primary models, P.808 mel features for model_v8, and a (1, 900, 161)
    log-power-like map for the two single-head models."""
    rng = np.random.default_rng(seed)
    if rel.endswith("sig_bak_ovr.onnx"):
        return golden_signal(seed=seed)[None]
    if rel.endswith("model_v8.onnx"):
        return tdnsmos.audio_melspec(golden_signal(seed=seed)[:-160])[None]
    return rng.standard_normal((1, 900, 161)).astype(np.float32)


@pytest.mark.parametrize("rel", GRAPHS)
def test_assets_and_parsed_graphs_match_jax(rel):
    """The port's five .onnx files are the JAX package's bytes, and
    parse_model gives the same nodes, attributes and initializers."""
    mine, theirs = _asset(tdnsmos, rel), _asset(jdnsmos, rel)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, want = texec.parse_model(mine), jexec.parse_model(theirs)
    assert got[2:] == want[2:]  # input and output names
    assert [(n.op, n.inputs, n.outputs) for n in got[0]] == \
        [(n.op, n.inputs, n.outputs) for n in want[0]]
    for a, b in zip(got[0], want[0]):
        assert a.attrs.keys() == b.attrs.keys()
        for k in a.attrs:
            np.testing.assert_array_equal(np.asarray(a.attrs[k]),
                                          np.asarray(b.attrs[k]))
    assert got[1].keys() == want[1].keys()
    for k, v in want[1].items():
        assert got[1][k].dtype == v.dtype
        np.testing.assert_array_equal(got[1][k], v)


CONV_CASES = [
    ((2, 3, 9, 8), (4, 3, 3, 3), {"pads": [1, 1, 1, 1]}),
    ((1, 2, 10, 7), (3, 2, 3, 2), {"strides": [2, 3], "pads": [0, 1, 2, 0]}),
    ((1, 4, 12, 6), (2, 4, 3, 3), {"dilations": [2, 1],
                                   "pads": [2, 1, 2, 1]}),
    ((2, 3, 20), (5, 3, 4), {"strides": [2], "pads": [1, 2]}),  # 1-D
]


def test_op_primitives_match_jax():
    """Conv on tests/test_dnsmos.py:93-101's cases (strides, asymmetric
    pads, dilation, 1-D; with and without bias), MaxPool and Slice with
    the INT64_MAX sentinel: numpy against JAX's numpy, torch against
    JAX's torch fast path."""
    import torch

    rng = np.random.default_rng(7)
    for xs, ws, attrs in CONV_CASES:
        x = rng.standard_normal(xs).astype(np.float32)
        w = rng.standard_normal(ws).astype(np.float32)
        for b in (None, rng.standard_normal(ws[0]).astype(np.float32)):
            want = jexec._conv_numpy(x, w, b, attrs)
            got = texec._conv_numpy(x, w, b, attrs)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
            tb = None if b is None else torch.from_numpy(b)
            got_t = texec._conv_torch(torch.from_numpy(x),
                                      torch.from_numpy(w), tb, attrs)
            np.testing.assert_allclose(got_t.numpy(),
                                       jexec._conv_torch(x, w, b, attrs),
                                       rtol=1e-4, atol=1e-5)
    x = rng.standard_normal((1, 2, 6, 5)).astype(np.float32)
    for attrs in ({"kernel_shape": [2, 2], "strides": [2, 2]},
                  {"kernel_shape": [2, 2], "strides": [2, 2],
                   "pads": [1, 0, 1, 1]}):
        want = jexec._maxpool(x, attrs)
        np.testing.assert_array_equal(texec._maxpool_numpy(x, attrs), want)
        np.testing.assert_array_equal(
            texec._maxpool_torch(torch.from_numpy(x), attrs).numpy(), want)
    args = ([1], [2**63 - 1], [2], [2])
    np.testing.assert_array_equal(texec._slice(x, *args),
                                  jexec._slice(x, *args))
    np.testing.assert_array_equal(
        torch.from_numpy(x)[texec._slice_args(x.ndim, *args)].numpy(),
        x[:, :, 1::2])


@pytest.mark.parametrize("rel", GRAPHS)
def test_graph_outputs_match_jax(rel):
    """Each graph on the port's torch backend (CPU) against JAX's
    executor; the integer initializers stay host ints, and every node
    output is a tensor of the session's device."""
    import torch

    feed = {"input_1": graph_input(rel)}
    sess = texec.InferenceSession(_asset(tdnsmos, rel), device="cpu")
    assert not any(isinstance(v, torch.Tensor) and not v.is_floating_point()
                   for v in sess.inits.values())
    env = sess.run_nodes(feed)
    for nd in sess.nodes:
        for o in nd.outputs:
            assert isinstance(env[o], torch.Tensor) and \
                env[o].device.type == "cpu", o
    (got,) = sess.run(None, feed)
    (want,) = jexec.InferenceSession(_asset(jdnsmos, rel)).run(None, feed)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= GRAPH_REL * np.abs(want).max()


def test_numpy_backend_matches_jax_numpy_path(monkeypatch):
    """The port's plain numpy executor against JAX's with its torch
    fast path switched off, on the P.808 graph, to 1e-9; and
    IDCCRN_ONNX_NUMPY=1 selects it."""
    monkeypatch.setattr(jexec, "_torch", None)
    rel = "DNSMOS/model_v8.onnx"
    feed = {"input_1": graph_input(rel, seed=3)}
    (want,) = jexec.InferenceSession(_asset(jdnsmos, rel)).run(None, feed)
    sess = texec.InferenceSession(_asset(tdnsmos, rel), backend="numpy")
    assert sess.backend == "numpy" and sess.device is None
    (got,) = sess.run(None, feed)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    monkeypatch.setenv("IDCCRN_ONNX_NUMPY", "1")
    assert texec.InferenceSession(_asset(tdnsmos, rel)).backend == "numpy"


def test_melspec_matches_jax():
    np.testing.assert_allclose(tdnsmos.mel_filterbank(16000, 321, 120),
                               jdnsmos.mel_filterbank(16000, 321, 120),
                               rtol=1e-9, atol=0)
    sig = golden_signal(seconds=2.0, seed=3)
    for to_db in (True, False):
        got = tdnsmos.audio_melspec(sig, to_db=to_db)
        want = jdnsmos.audio_melspec(sig, to_db=to_db)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert tdnsmos._POLY == jdnsmos._POLY


def _check_scores(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, rtol=SCORE_REL, err_msg=k)


@pytest.fixture(scope="module")
def scorers():
    """(port, JAX) scorer, non-personalized and personalized."""
    return {
        p: (tdnsmos.ComputeScore(*tdnsmos.default_model_paths(p),
                                 device="cpu"),
            jdnsmos.ComputeScore(*jdnsmos.default_model_paths(p)))
        for p in (False, True)}


@pytest.mark.parametrize("personalized,seconds,fs,hops", [
    (False, 9.01, FS, 1), (True, 12.0, FS, 3), (False, 4.0, FS, 7),
    (True, 9.5, 8000, 1)], ids=["golden", "personalized-3hops", "4s",
                                "8kHz"])
def test_score_array_matches_jax(scorers, personalized, seconds, fs, hops):
    """score_array on the golden signal (and the pinned goldens), three
    hops personalized, a 4 s input (doubled to 16 s: 7 hops), and an
    8 kHz input resampled to 16 kHz."""
    mine, theirs = scorers[personalized]
    sig = golden_signal(seconds, fs)
    got = mine.score_array(sig, fs, personalized)
    _check_scores(got, theirs.score_array(sig, fs, personalized))
    assert got["num_hops"] == hops and got["sr"] == FS
    if (personalized, seconds, fs) == (False, 9.01, FS):
        for k, v in GOLDENS.items():
            assert got[k] == pytest.approx(v, abs=1e-4), k


def test_score_array_rejects_empty_audio(scorers):
    for scorer in scorers[False]:
        with pytest.raises(ValueError, match="empty audio"):
            scorer.score_array(np.zeros(0, np.float32), FS)


def test_score_directory_and_cli_match_jax(tmp_path, capsys):
    """score_directory and the CLI with --device cpu over three wavs (one
    at 8 kHz): the same rows as the JAX function, and the CSV text that
    pandas' to_csv writes for those rows (the JAX function's writer)."""
    pd = pytest.importorskip("pandas")
    from idccrn_vae_torch.cli.dnsmos import main
    from idccrn_vae_torch.data.audio_io import write_wav

    d = tmp_path / "wavs"
    d.mkdir()
    for i, (seconds, fs) in enumerate(((9.2, FS), (3.0, FS), (9.3, 8000))):
        write_wav(str(d / f"enh_fileid_{i}.wav"),
                  golden_signal(seconds, fs, seed=10 + i), fs)
    primary, p808 = tdnsmos.default_model_paths(False)
    rows = tdnsmos.score_directory(str(d), primary, p808, device="cpu",
                                   csv_path=str(tmp_path / "port.csv"))
    want = sorted(jdnsmos.score_directory(
        str(d), *jdnsmos.default_model_paths(False),
        csv_path=str(tmp_path / "jax.csv")), key=lambda r: r["filename"])
    assert [r["filename"] for r in rows] == [r["filename"] for r in want]
    for got, w in zip(rows, want):
        _check_scores(got, w)
    with open(tmp_path / "port.csv") as f, open(tmp_path / "jax.csv") as g:
        header = next(csv.reader(f))
        assert header == next(csv.reader(g))
    assert header[0] == ""
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv")
    with open(tmp_path / "port.csv") as f, \
            open(tmp_path / "pandas.csv") as g:
        assert f.read() == g.read()

    main(["-t", str(d), "-o", str(tmp_path / "cli.csv"), "--device", "cpu"])
    with open(tmp_path / "cli.csv") as f, open(tmp_path / "port.csv") as g:
        assert f.read() == g.read()
    main(["-t", str(d), "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [str(r) for r in rows]
