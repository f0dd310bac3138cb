"""The port's last helper modules against the JAX package's, on the CPU:
ops/complex.py, data/features.py, utils/debug.py and utils/profiling.py.

Tolerances:
  * the cpack helpers: bit for bit at float32 (slices, concatenations,
    products and sums, the same on both sides), except `cabs`: torch's
    vectorised CPU square root is not always correctly rounded (one
    element in 120 here is one float32 step from numpy's and XLA's), so
    `cabs` is held to one float32 step (rtol 2**-23);
  * spec_features on a seeded 0.5 s waveform at the package's STFT
    (512 / 100 / 400): 'MagSpec' and 'Complex' within 1e-5 of max |ref|
    (two FFT libraries in float32; read: 1.2e-7). 'LogPow' within 1e-4
    dB at the bins within 40 dB of the peak. Below that the two float32
    FFTs' absolute difference, a fixed share of the peak, is a growing
    share of the bin: a magnitude error e * max|X| moves a bin of
    magnitude |X| by 20 log10(e) * e * max|X| / |X| dB. Those bins, down
    to the -80 dB floor, are held to that with e = 1e-5, the MagSpec
    bound (read: 3.8e-4 dB at -60 to -80 dB, bound 0.87 dB there);
  * the debug checks: the same inputs raise on both sides, with the same
    message (the leaf's path and its NaN and Inf counts);
  * the profiling helpers: JAX's keys (on the CPU log_memory has the
    host's alone), and `trace` writes a Chrome trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_torch.data.features import spec_features
from idccrn_vae_torch.ops import complex as tc
from idccrn_vae_torch.utils import debug as tdebug
from idccrn_vae_torch.utils import profiling as tprof
from idccrn_vae_tpu.data.features import spec_features as jax_spec_features
from idccrn_vae_tpu.ops import complex as jc
from idccrn_vae_tpu.utils import debug as jdebug
from idccrn_vae_tpu.utils import profiling as jprof
import torch_port_util  # noqa: F401  (thread cap of the port tests)

FS = 16000


def _same(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(port, np.asarray(ref))
    assert port.dtype == np.asarray(ref).dtype


@pytest.mark.parametrize("name", ["creal", "cimag", "cabs2",
                                  "cpack_to_pair"])
def test_cpack_helper_matches_jax_bit_for_bit(name):
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 8)).astype(
        np.float32)
    _same(getattr(tc, name)(torch.from_numpy(x)),
          getattr(jc, name)(jnp.asarray(x)))


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_cabs_matches_jax_to_one_float32_step(eps):
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 8)).astype(
        np.float32)
    got = tc.cabs(torch.from_numpy(x), eps=eps).numpy()
    want = np.asarray(jc.cabs(jnp.asarray(x), eps=eps))
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 3, 5, 4)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)


def test_csplit_cpack_and_pair_layouts_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    for got, want in zip(tc.csplit(torch.from_numpy(x)),
                         jc.csplit(jnp.asarray(x))):
        _same(got, want)
    re, im = x[..., :4], x[..., 4:]
    _same(tc.cpack(torch.from_numpy(re), torch.from_numpy(im)),
          jc.cpack(jnp.asarray(re), jnp.asarray(im)))
    pair = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    _same(tc.pair_to_cpack(torch.from_numpy(pair)),
          jc.pair_to_cpack(jnp.asarray(pair)))
    # the two layouts are each other's inverse
    _same(tc.pair_to_cpack(tc.cpack_to_pair(torch.from_numpy(x))), x)


@pytest.fixture(scope="module")
def waveform():
    rng = np.random.default_rng(2)
    t = np.arange(FS // 2) / FS
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("feattype", ["LogPow", "MagSpec", "Complex"])
def test_spec_features_match_jax(waveform, feattype):
    got = spec_features(waveform, feattype)
    want = np.asarray(jax_spec_features(waveform, feattype))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.shape[:2] == (257, 1 + waveform.size // 100)
    err = np.abs(got - want)
    if feattype == "LogPow":
        level = want - want.max()  # dB under the peak bin
        assert err[level > -40.0].max() <= 1e-4
        bound = 20.0 * np.log10(np.e) * 1e-5 * 10.0 ** (-level / 20.0)
        assert (err <= np.maximum(bound, 1e-4)).all()
    else:
        assert err.max() <= 1e-5 * np.abs(want).max(), err.max()


def test_spec_features_refuse_an_unknown_type(waveform):
    for fn in (spec_features, jax_spec_features):
        with pytest.raises(ValueError, match="unknown feattype"):
            fn(waveform, "Mel")


def _trees():
    """(name, numpy tree for JAX, the same tree for the port)."""
    nan = np.array([1.0, np.nan, np.nan], np.float32)
    inf = np.array([[np.inf, 0.0], [-np.inf, 1.0]], np.float32)
    ok = np.ones((2, 2), np.float32)
    t = torch.from_numpy
    return [
        ("finite", {"a": ok, "b": [ok, (ok, ok)]},
         {"a": t(ok), "b": [t(ok), (t(ok), t(ok))]}),
        ("nan", {"w": ok, "b": [ok, nan]},
         {"w": t(ok), "b": [t(ok), t(nan)]}),
        ("inf", {"z": {"y": inf}, "a": [ok]},
         {"z": {"y": t(inf)}, "a": [t(ok)]}),
        ("first_of_two", {"q": nan, "p": {"r": inf}},
         {"q": t(nan), "p": {"r": t(inf)}}),
        ("bf16", {"x": [ok, inf]},
         {"x": [t(ok).bfloat16(), t(inf).bfloat16()]}),
    ]


def _raised(fn, *args):
    try:
        fn(*args)
    except RuntimeError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", [c[0] for c in _trees()])
def test_check_finite_raises_as_jax_does(case):
    _, jtree, ttree = next(c for c in _trees() if c[0] == case)
    want = _raised(jdebug.check_finite, jtree, "params")
    got = _raised(tdebug.check_finite, ttree, "params")
    assert got == want
    assert (want is None) == (case == "finite")


def test_check_finite_reads_a_module_state_dict():
    lin = torch.nn.Linear(3, 2)
    tdebug.check_finite(lin, "model")
    with torch.no_grad():
        lin.bias[1] = float("nan")
    want = _raised(jdebug.check_finite,
                   {k: v.numpy() for k, v in lin.state_dict().items()},
                   "model")
    got = _raised(tdebug.check_finite, {"enc": lin}, "model")
    assert want == "NaN/Inf detected in model:['bias'] (nan=1, inf=0)"
    assert got == "NaN/Inf detected in model:['enc']/['bias'] (nan=1, inf=0)"
    assert _raised(tdebug.check_finite, lin, "model") == want


@pytest.mark.parametrize("value", [1.0, float("nan"), float("inf")])
def test_checkify_finite_raises_as_jax_does(value):
    from jax.experimental import checkify

    x = np.array([0.5, value, 2.0], np.float32)
    err, out = jax.jit(checkify.checkify(
        lambda y: jdebug.checkify_finite(y, "x") * 2.0))(jnp.asarray(x))
    try:
        err.throw()
        want = None
    except Exception as e:  # JaxRuntimeError
        want = str(e)
    xt = torch.from_numpy(x)
    got = _raised(tdebug.checkify_finite, xt, "x")
    assert (got is None) == (want is None)
    if got is None:
        assert tdebug.checkify_finite(xt, "x") is xt
    else:
        assert got == "NaN/Inf detected in x" and got in want


def test_checkify_finite_raises_under_torch_compile():
    """The check breaks the graph and runs eagerly between the compiled
    parts (the eager backend: no compiler needed on the CPU)."""
    fn = torch.compile(lambda y: tdebug.checkify_finite(y * 2.0, "y") + 1.0,
                       backend="eager")
    np.testing.assert_array_equal(fn(torch.ones(3)).numpy(), 3.0)
    with pytest.raises(RuntimeError, match="NaN/Inf detected in y"):
        fn(torch.tensor([1.0, float("inf")]))


def test_global_nan_debugging_turns_on_anomaly_mode():
    was = torch.is_anomaly_enabled()
    try:
        tdebug.enable_global_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="returned nan"):
            (x.sqrt() * 0.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_step_timer_and_log_memory_have_jax_keys():
    timers = []
    for timer, probe in ((jprof.StepTimer("s"), jnp.ones(3)),
                         (tprof.StepTimer("s"), {"out": torch.ones(3)})):
        for _ in range(3):
            with timer:
                sum(range(1000))
        timer.__enter__()
        timer.block_and_stop(probe)
        timers.append(timer.summary())
    assert set(timers[1]) == set(timers[0])
    assert timers[1]["count"] == 4 and timers[1]["total_s"] >= 0
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary() == {}
    assert set(tprof.log_memory()) == set(jprof.log_memory()) \
        == {"host_rss_mb"}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("aten::mm" == e.key for e in prof.key_averages())
