"""Native PESQ-WB: ITU-T P.862.2 objective speech quality in numpy.

The port's copy of `idccrn_vae_tpu/eval/pesq_native.py`, line for line
(numpy and scipy only), so both packages score alike.

The reference scores PESQ through the `pesq` PyPI package (ITU
reference C code; the reference's utils/eval_metrics.py:99-110). That
package is not a dependency, so this module implements
the P.862 psychoacoustic model + P.862.2 wideband mapping directly:

  1. level alignment of both signals to a fixed active-band power
     (350-3250 Hz, target 1e7),
  2. the P.862.2 wideband input IIR filter,
  3. constant-delay time alignment (full-waveform cross-correlation),
  4. 32 ms Hann-windowed power spectra (512-sample frames, 50%
     overlap at 16 kHz),
  5. Bark-warped pitch power densities over the ITU 49-band partition
     with the 100/nr_of_hz_bands power-density correction and the
     published Sp scaling,
  6. full (bounded-ratio) compensation of the reference for linear
     frequency response, then bounded + time-smoothed short-term gain
     compensation of the degraded signal (both per P.862
     freq_resp_compensation / the 0.2-0.8 scale recursion with the
     5e3 floor and [3e-4, 5] bounds),
  7. Zwicker-law loudness (exponent 0.23, Sl scaling, low-band
     exponent modification below 4 Bark),
  8. masked disturbance (0.25 * min deadzone) and asymmetric
     disturbance ((deg+50 / ref+50)^1.2, gated at 3, clipped at 12),
  9. per-frame Bark-width-weighted pseudo-Lp (p=2 symmetric, p=1
     asymmetric, bands 1..48), division by the ((P+1e5)/1e7)^0.04
     frame emphasis, both channels clipped at 45, then L6 within
     half-overlapping 20-frame syllables and L2 across syllables
     (D_POW_F/S/T = 2/6/2, A_POW_F/S/T = 1/6/2),
  10. raw = 4.5 - 0.1*D - 0.0309*DA, then the P.862.2 logistic map
      MOS-LQO = 0.999 + 4 / (1 + exp(-1.3669*raw + 3.8224)).

PARAMETER PROVENANCE: the four 49-entry parameter tables below
(centre_of_band_bark, width_of_band_bark, abs_thresh_power,
centre_of_band_hz) are the published ITU-T P.862 16 kHz constants
(reference C `pesqpar.h`, reproduced in every open PESQ port),
vendored verbatim, as are the integer FFT-bin->band grouping
(`nr_of_hz_bands_per_bark_band_16k`) and the 26-point level-alignment
filter mask (`align_filter_dB`). They cross-validate via independent
internal invariants checked in tests/test_pesq_native.py: adjacent
band centres telescope exactly through the widths, every absolute
threshold sits exactly on a 0.01 dB grid, the low-frequency warping
satisfies bark = hz/100, and an independent DERIVATION of the bin
grouping from the warping tables (piecewise-linear Hz->Bark through
the 49 published centres, kept in `_derive_grouping`) reproduces the
vendored table at 47/49 bands exactly — the remaining two (bands
16/17) differ by a single boundary-bin placement, the known ambiguity
of reconstructing an integer partition from float centres.
pow_dens_correction = 100/nr matches the published float table to
<=1e-5 relative. Scalar constants (Sp, Sl, weights, bounds) are the
published P.862 values.

Time alignment follows the ITU structure: global constant-delay crude
alignment, then per-utterance fine alignment over VAD-delimited
utterances with recursive splitting on internal delay discontinuities
(align_variable_delay — the utterance_locate/time_align/split_align
roles, simplified: energy-threshold VAD instead of the ITU iterative
VAD, correlation-sum split acceptance instead of the ITU bad-interval
re-scoring). For zero/constant delay — the in-place speech-enhancement
case — the variable-delay stage is an exact identity, pinned by
tests/test_pesq_native.py::test_constant_delay_invariance.

Known remaining deviations from the ITU reference code, outside the
psychoacoustic model: the simplified VAD/split acceptance above, and
the >16 s long-signal time weighting (identity for the 3-10 s
utterances this framework evaluates). tools/validate_pesq.py measures
the residual offset against the ITU package when one is importable.
"""

from __future__ import annotations

import numpy as np

FS = 16000
NFFT = 512          # 32 ms at 16 kHz
HOP = NFFT // 2
NB = 49             # bark bands in the 16 kHz mode
SP = 6.910853e-6    # power scaling factor Sp_16k (pesqpar.h)
SL = 1.866055e-1    # loudness scaling factor Sl_16k (pesqpar.h)
ZWICKER_POWER = 0.23
TARGET_POWER = 1e7
DATAPADDING = int(0.320 * FS)  # DATAPADDING_MSECS = 320
MIN_SCALE = 3e-4
MAX_SCALE = 5.0
D_WEIGHT = 0.1
A_WEIGHT = 0.0309
PSQM_FRAMES_PER_SYLLABLE = 20

# ---------------------------------------------------------------------------
# ITU-T P.862 16 kHz parameter tables (pesqpar.h), vendored verbatim.
# ---------------------------------------------------------------------------

CENTRE_OF_BAND_BARK = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450,
    1.624217, 1.962597, 2.305636, 2.653383, 3.005889,
    3.363201, 3.725371, 4.092449, 4.464486, 4.841533,
    5.223642, 5.610866, 6.003256, 6.400869, 6.803755,
    7.211971, 7.625571, 8.044611, 8.469146, 8.899232,
    9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232,
    14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478,
    19.319147, 19.886751, 20.461355, 21.043034])

WIDTH_OF_BAND_BARK = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474,
    0.336061, 0.340697, 0.345381, 0.350114, 0.354897,
    0.359729, 0.364611, 0.369544, 0.374529, 0.379565,
    0.384653, 0.389794, 0.394989, 0.400236, 0.405538,
    0.410894, 0.416306, 0.421773, 0.427297, 0.432877,
    0.438514, 0.444209, 0.449962, 0.455774, 0.461645,
    0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745,
    0.530308, 0.536934, 0.543629, 0.550390, 0.557220,
    0.564119, 0.571085, 0.578125, 0.585232])

ABS_THRESH_POWER = np.array([
    51286152.0, 2454709.500, 70794.593750, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372,
    4.897789, 3.090296, 1.905461, 1.258925, 0.977237,
    0.724436, 0.562341, 0.457088, 0.389045, 0.331131,
    0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030,
    0.338844, 0.371535, 0.398107, 0.436516, 0.467735,
    0.489779, 0.501187, 0.501187, 0.512861, 0.524807,
    0.524807, 0.524807, 0.512861, 0.478630, 0.426580,
    0.371535, 0.363078, 0.416869, 0.537032])

CENTRE_OF_BAND_HZ = np.array([
    7.867213, 31.634144, 63.655895, 96.124611, 129.044968,
    162.421738, 196.259659, 230.563568, 265.338348, 300.588867,
    336.320129, 372.537140, 409.244934, 446.486633, 484.568604,
    526.600586, 570.303833, 619.423340, 672.121643, 728.525696,
    785.675964, 846.835693, 909.691650, 977.063293, 1049.861694,
    1129.635986, 1217.257568, 1312.109497, 1412.501465, 1517.999390,
    1628.894165, 1746.194336, 1871.568848, 2008.776123, 2158.979248,
    2326.743164, 2513.787109, 2722.488770, 2952.586670, 3205.835449,
    3492.679932, 3820.219238, 4193.938477, 4619.846191, 5100.437012,
    5636.199219, 6234.313477, 6946.734863, 7796.473633])


# ITU P.862 `nr_of_hz_bands_per_bark_band_16k` (pesqpar.h), vendored
# verbatim: how many consecutive FFT bins (31.25 Hz spacing, DC first)
# each of the 49 Bark bands consumes. Sums to 256 = NFFT/2.
NR_OF_HZ_BANDS_PER_BARK_BAND_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1,
    1, 1, 1, 1, 2, 1, 1, 2, 2, 2,
    2, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    3, 4, 5, 4, 5, 6, 6, 7, 8, 9,
    9, 12, 12, 15, 16, 18, 21, 25, 20], dtype=np.int64)


def _derive_grouping():
    """Independent re-derivation of the bin->band partition from the
    vendored warping tables — kept as a cross-check of the vendored
    integer table (tests/test_pesq_native.py asserts 47/49 agreement;
    bands 16/17 place one boundary bin differently, the irreducible
    ambiguity of reconstructing the partition from float centres).

    Each bin is mapped to Bark via piecewise-linear interpolation
    through (0,0) and the 49 published (centre_hz, centre_bark) pairs
    (last-slope extrapolation above the top centre), then assigned to
    the band whose [centre - width/2, centre + width/2) Bark interval
    contains it.
    """
    bin_hz = np.arange(NFFT // 2) * (FS / NFFT)           # 0 .. 7968.75
    hz_pts = np.concatenate([[0.0], CENTRE_OF_BAND_HZ])
    bark_pts = np.concatenate([[0.0], CENTRE_OF_BAND_BARK])
    bin_bark = np.interp(bin_hz, hz_pts, bark_pts)
    slope = (bark_pts[-1] - bark_pts[-2]) / (hz_pts[-1] - hz_pts[-2])
    hi = bin_hz > hz_pts[-1]
    bin_bark[hi] = bark_pts[-1] + (bin_hz[hi] - hz_pts[-1]) * slope
    edges = np.concatenate(
        [CENTRE_OF_BAND_BARK - WIDTH_OF_BAND_BARK / 2,
         [CENTRE_OF_BAND_BARK[-1] + WIDTH_OF_BAND_BARK[-1] / 2]])
    band = np.clip(np.searchsorted(edges, bin_bark, side="right") - 1,
                   0, NB - 1)
    nr = np.bincount(band, minlength=NB)
    return nr


def _build_grouping(nr):
    """(NB, NFFT/2) 0/1 matrix assigning consecutive bins per the ITU
    counts (P.862 freq_warping walks hz_band forward band by band)."""
    band = np.repeat(np.arange(NB), nr)
    group = np.zeros((NB, NFFT // 2))
    group[band, np.arange(NFFT // 2)] = 1.0
    return group


_NR_OF_HZ_BANDS = NR_OF_HZ_BANDS_PER_BARK_BAND_16K.astype(np.float64)
_GROUP = _build_grouping(NR_OF_HZ_BANDS_PER_BARK_BAND_16K)
# P.862 pow_dens_correction_factor: 100 / nr_of_hz_bands (the ITU table
# equals this up to <=1e-5 relative float artifacts)
_POW_DENS_CORRECTION = 100.0 / _NR_OF_HZ_BANDS


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


# ITU P.862 `align_filter_dB` (pesqmain.c), vendored verbatim: the
# 26-point (Hz, dB) piecewise-linear response of the level-alignment
# bandpass. -500 dB = stop; the 300->350 Hz and 3250->3500 Hz segments
# are linear-in-dB transition ramps (NOT a brickwall).
ALIGN_FILTER_DB = np.array([
    [0.0, -500.0], [50.0, -500.0], [100.0, -500.0], [125.0, -500.0],
    [160.0, -500.0], [200.0, -500.0], [250.0, -500.0], [300.0, -500.0],
    [350.0, 0.0], [400.0, 0.0], [500.0, 0.0], [600.0, 0.0],
    [630.0, 0.0], [800.0, 0.0], [1000.0, 0.0], [1250.0, 0.0],
    [1600.0, 0.0], [2000.0, 0.0], [2500.0, 0.0], [3000.0, 0.0],
    [3250.0, 0.0], [3500.0, -500.0], [4000.0, -500.0], [5000.0, -500.0],
    [6300.0, -500.0], [8000.0, -500.0]])


def _apply_filter_db(x, curve):
    """P.862 apply_filter: zero-pad to the next power of two, FFT,
    multiply each bin by 10^(dB/20) with the dB response interpolated
    piecewise-linearly through `curve` and normalized to the 1 kHz
    response, inverse FFT, truncate."""
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(n)))
    spec = np.fft.rfft(x, nfft)
    f = np.arange(len(spec)) * (FS / nfft)
    db = np.interp(f, curve[:, 0], curve[:, 1])
    db -= np.interp(1000.0, curve[:, 0], curve[:, 1])  # overallGainFilter
    return np.fft.irfft(spec * 10.0 ** (db / 20.0), nfft)[:n]


def fix_power_level(x):
    """Scale so the align-filtered band power averages TARGET_POWER
    (P.862 fix_power_level). Per the ITU code, the power divisor
    includes the DATAPADDING tail (pow_of's divisor is
    Nsamples + DATAPADDING_MSECS*(Fs/1000)) even though the padding is
    appended later in this flow — the zeros contribute no energy but
    do dilute the mean."""
    band = _apply_filter_db(x, ALIGN_FILTER_DB)
    power = (band ** 2).sum() / (len(x) + DATAPADDING) + 1e-20
    return x * np.sqrt(TARGET_POWER / power)


# P.862.2 wideband input filter: the published 16 kHz IIR
# (b = 2.6657628*[1, -2, 1], a = [1, -1.8890331, 0.89487434]).
_WB_B = np.array([2.6657628, -5.3315255, 2.6657628])
_WB_A = np.array([1.0, -1.8890331, 0.89487434])


def _wb_input_filter(x):
    from scipy.signal import lfilter

    return lfilter(_WB_B, _WB_A, x)


def estimate_delay(ref, deg, max_delay=FS // 2):
    """Constant relative delay of deg vs ref via full-waveform FFT
    cross-correlation (global maximum within +-max_delay). Robust to
    periodic content where block-envelope correlation can lock onto a
    pitch period."""
    from scipy.signal import fftconvolve

    n = min(len(ref), len(deg))
    c = fftconvolve(deg[:n], ref[:n][::-1], mode="full")
    lags = np.arange(-n + 1, n)
    keep = np.abs(lags) <= max_delay
    return int(lags[keep][np.argmax(c[keep])])


# ---------------------------------------------------------------------------
# per-utterance variable-delay alignment (P.862 utterance_locate structure)
# ---------------------------------------------------------------------------

_VAD_BLOCK = FS // 250          # 4 ms energy blocks (ITU apply_VAD grain)
_UTT_JOIN = int(0.200 * FS)     # join speech sections gapped < 200 ms
_UTT_MIN = int(0.064 * FS)      # drop active sections shorter than this
_FINE_RANGE = int(0.075 * FS)   # per-utterance residual search window
_SPLIT_MIN = int(0.300 * FS)    # don't split utterances below this


def _utterance_spans(ref):
    """Speech-utterance [start, end) sample spans of the (level-aligned)
    reference, from 4 ms block energies: active = above the whole-signal
    mean block energy / 50, sections joined across < 200 ms gaps and
    short blips dropped — the same segmentation role as P.862's
    apply_VAD + id_searchwindows (utterances are VAD sections separated
    by long silences), without the ITU code's iterative threshold."""
    nb = len(ref) // _VAD_BLOCK
    if nb == 0:
        return [(0, len(ref))]
    e = (ref[: nb * _VAD_BLOCK] ** 2).reshape(nb, _VAD_BLOCK).mean(axis=1)
    thr = e.mean() / 50.0
    active = e > thr
    spans = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append([start * _VAD_BLOCK, i * _VAD_BLOCK])
            start = None
    if start is not None:
        spans.append([start * _VAD_BLOCK, nb * _VAD_BLOCK])
    # join across short gaps
    joined = []
    for s in spans:
        if joined and s[0] - joined[-1][1] < _UTT_JOIN:
            joined[-1][1] = s[1]
        else:
            joined.append(s)
    out = [(a, b) for a, b in joined if b - a >= _UTT_MIN]
    return out or [(0, len(ref))]


def _segment_delay(ref, deg, a, b):
    """(residual_delay, peak_corr, zero_lag_corr) of deg vs ref over
    [a, b), searching +-_FINE_RANGE around the already-applied global
    delay (the fine-alignment role of P.862 time_align)."""
    from scipy.signal import fftconvolve

    r = ref[a:b]
    lo = max(0, a - _FINE_RANGE)
    hi = min(len(deg), b + _FINE_RANGE)
    d = deg[lo:hi]
    if len(d) < len(r) or not len(r):
        return 0, 0.0, 0.0
    c = fftconvolve(d, r[::-1], mode="valid")  # lag = lo - a + index
    lags = np.arange(len(c)) + (lo - a)
    zero_idx = int(np.flatnonzero(lags == 0)[0]) if (lags == 0).any() else 0
    best = int(np.argmax(np.abs(c)))
    return int(lags[best]), float(abs(c[best])), float(abs(c[zero_idx]))


def _locate_utterance_delays(ref, deg, a, b):
    """[(start, end, residual_delay)] for ref[a:b]: fine-align the whole
    utterance, then recursively try a midpoint split and keep it when
    the halves' correlations beat the unsplit peak with genuinely
    different delays (the accept test of P.862 split_align)."""
    d, c, c0 = _segment_delay(ref, deg, a, b)
    # confidence gate: a residual only counts when its peak clearly
    # beats staying at the global alignment — spurious noise peaks on
    # heavily degraded signals must not move the alignment
    if abs(c) <= 1.1 * c0:
        d, c = 0, c0
    if b - a >= 2 * _SPLIT_MIN:
        m = (a + b) // 2
        d1, c1, c01 = _segment_delay(ref, deg, a, m)
        d2, c2, c02 = _segment_delay(ref, deg, m, b)
        if abs(c1) <= 1.1 * c01:
            d1 = 0
        if abs(c2) <= 1.1 * c02:
            d2 = 0
        if d1 != d2 and c1 + c2 > 1.05 * c:
            return (_locate_utterance_delays(ref, deg, a, m)
                    + _locate_utterance_delays(ref, deg, m, b))
    return [(a, b, d)]


def align_variable_delay(ref, deg):
    """Per-utterance variable-delay compensation of `deg` against `ref`
    (both already globally aligned): VAD-delimited utterances are
    fine-aligned (and split on internal delay discontinuities) and each
    span of deg is shifted by its own residual delay. When every
    residual is zero — the in-place enhancement case — the output is
    `deg` unchanged, so constant-delay scores are bit-identical.

    Returns (deg_aligned, [(start, end, residual_delay)])."""
    pieces = []
    for a, b in _utterance_spans(ref):
        pieces.extend(_locate_utterance_delays(ref, deg, a, b))
    if all(d == 0 for _a, _b, d in pieces):
        return deg, pieces
    out = deg.copy()
    for a, b, d in pieces:
        if d == 0:
            continue
        src_a, src_b = a + d, b + d
        seg = np.zeros(b - a, deg.dtype)
        ca, cb = max(0, src_a), min(len(deg), src_b)
        if cb > ca:
            seg[ca - src_a : ca - src_a + (cb - ca)] = deg[ca:cb]
        out[a:b] = seg
    return out, pieces


# ---------------------------------------------------------------------------
# psychoacoustic model (P.862 pesqmod.c structure, vectorized over frames)
# ---------------------------------------------------------------------------


def _frames(x):
    n = (len(x) - NFFT) // HOP + 1
    idx = np.arange(n)[:, None] * HOP + np.arange(NFFT)[None, :]
    return x[idx]


def _pitch_power_densities(x):
    """(T, NB) pitch power densities: unnormalized |FFT|^2 of Hann
    frames, grouped to Bark bands, * pow_dens_correction * Sp
    (P.862 short_term_fft + freq_warping).

    CALIBRATION NOTE (probed — do not "fix" this again): the
    UNNORMALIZED power spectrum is correct here. One could conjecture
    the vendored ITU constants assume a 1/NFFT-scaled FFT
    (the silent-frame criterion compares total audible power against
    1e7, and active frames run ~5e9). Dividing by NFFT was tried and
    makes the metric provably WRONG against external anchors: 20 dB
    white noise scores 4.08 (published PESQ-WB for white noise at
    20 dB SNR is ~2), replacing the degraded signal with silence
    scores 3.79 (real PESQ: ~1.0-1.6), and noisy-speech testset means
    come out ~2.5-3.0 where published noisy baselines are 1.58 (DNS,
    0-25 dB) / 1.97 (VB-DMD, 2.5-17.5 dB). The unnormalized curve
    (1.04 / 1.18 / 1.75 / 2.46 / 3.01 at 0/10/20/30/40 dB white noise)
    tracks those anchors; the 1e7 silent threshold is a GATE far below
    active-frame power (ITU total_audible at factor 1e2), not a target
    the active frames sit at. tests/test_pesq_native.py::
    test_external_snr_anchor_band pins this calibration."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(NFFT) / NFFT))
    fr = _frames(x) * w
    spec = np.fft.rfft(fr, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : NFFT // 2]
    return (power @ _GROUP.T) * (_POW_DENS_CORRECTION * SP)[None, :]


def _total_audible(pp, factor):
    """Per-frame supra-threshold band power, bands 1..NB-1 (P.862
    total_audible skips the DC band). pp: (T, NB) -> (T,)."""
    p = pp[:, 1:]
    return np.where(p > ABS_THRESH_POWER[None, 1:] * factor, p, 0.0).sum(axis=1)


def _time_avg_audible(pp, silent):
    """Per-band average over non-silent frames of power > 100*threshold,
    divided by the TOTAL frame count (P.862 time_avg_audible_of keeps
    that denominator). pp: (T, NB) -> (NB,)."""
    mask = (~silent)[:, None] & (pp > 100.0 * ABS_THRESH_POWER[None, :])
    return np.where(mask, pp, 0.0).sum(axis=0) / len(pp)


def _loudness(pp):
    """Zwicker-law specific loudness (T, NB) with the P.862 low-band
    exponent modification below 4 Bark (intensity_warping_of)."""
    h = np.where(CENTRE_OF_BAND_BARK < 4.0,
                 np.minimum(6.0 / (CENTRE_OF_BAND_BARK + 2.0), 2.0), 1.0)
    gamma = ZWICKER_POWER * h ** 0.15
    t = ABS_THRESH_POWER[None, :]
    loud = (SL * (t / 0.5) ** gamma[None, :]
            * ((0.5 + 0.5 * pp / t) ** gamma[None, :] - 1.0))
    return np.where(pp > t, loud, 0.0)


def _pseudo_lp(d, p):
    """P.862 pseudo_Lp: Bark-width-weighted Lp over bands 1..NB-1
    (the DC band is excluded), rescaled by the total width.
    d: (T, NB) -> (T,)."""
    w = WIDTH_OF_BAND_BARK[None, 1:]
    tot = WIDTH_OF_BAND_BARK[1:].sum()
    return (((np.abs(d[:, 1:]) * w) ** p).sum(axis=1) / tot) ** (1.0 / p) * tot


def _lpq_weight(frame_d, p_syl, p_time):
    """P.862 Lpq_weight: L_{p_syl} within half-overlapping 20-frame
    syllables (the mean keeps denominator 20 even for tail syllables,
    i.e. virtual zero frames count), then L_{p_time} across syllables.
    Time weights are 1 for <16 s signals (this framework's case)."""
    n = len(frame_d)
    result_time = 0.0
    count = 0
    for s in range(0, n, PSQM_FRAMES_PER_SYLLABLE // 2):
        seg = frame_d[s : s + PSQM_FRAMES_PER_SYLLABLE]
        r = (seg ** p_syl).sum() / PSQM_FRAMES_PER_SYLLABLE
        result_time += r ** (p_time / p_syl)
        count += 1
    return float((result_time / count) ** (1.0 / p_time))


def _raw_pesq_to_mos_lqo(raw):
    """P.862.2 wideband logistic mapping."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def pesq_wb_native(ref, deg, fs=FS) -> float:
    """PESQ-WB MOS-LQO of degraded `deg` against clean `ref`."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    if fs != FS:
        from idccrn_vae_torch.data.audio_io import resample

        ref = np.asarray(resample(ref, fs, FS), np.float64)
        deg = np.asarray(resample(deg, fs, FS), np.float64)

    # 1-2. level align + WB input filter
    ref = _wb_input_filter(fix_power_level(ref))
    deg = _wb_input_filter(fix_power_level(deg))

    # 3. time alignment: global constant delay (crude align), then
    # per-utterance residual refinement with discontinuity splitting
    # (the utterance_locate/split_align role; identity when every
    # residual is zero, i.e. the in-place enhancement case)
    delay = estimate_delay(ref, deg)
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    ref = np.concatenate([ref[:n], np.zeros(DATAPADDING)])
    deg = np.concatenate([deg[:n], np.zeros(DATAPADDING)])
    deg, _spans = align_variable_delay(ref, deg)

    # 4-5. pitch power densities
    pp_ref = _pitch_power_densities(ref)
    pp_deg = _pitch_power_densities(deg)

    # silent-frame flags of the reference (P.862: total audible power at
    # factor 1e2 below 1e7)
    tot_ref_100 = _total_audible(pp_ref, 1e2)
    silent = tot_ref_100 < 1e7
    if _total_audible(pp_ref, 1.0).max() <= 0.0:
        # degenerate (inaudible) reference: the ITU code (and the `pesq`
        # package, NoUtterancesError) refuses to score rather than
        # returning the raw-offset maximum MOS; raising here lets
        # metrics.pesq_wb apply the reference's 0.0 substitution
        # (utils/eval_metrics.py:105-110).
        raise ValueError("no speech-active frames in the reference signal")

    # 6a. frequency-response compensation of the REFERENCE toward the
    # degraded long-term spectrum (full bounded ratio, P.862
    # freq_resp_compensation)
    avg_ref = _time_avg_audible(pp_ref, silent)
    avg_deg = _time_avg_audible(pp_deg, silent)
    ratio = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    mod_ref = pp_ref * ratio[None, :]

    # 6b. short-term gain compensation of the degraded signal: raw scale
    # (mod_ref+5e3)/(deg+5e3), 0.2/0.8 recursion (frame 0 unsmoothed),
    # clipped AFTER smoothing to [MIN_SCALE, MAX_SCALE]
    num = _total_audible(mod_ref, 1.0) + 5e3
    den = _total_audible(pp_deg, 1.0) + 5e3
    raw_scale = num / den
    sm = np.empty_like(raw_scale)
    prev = raw_scale[0]
    sm[0] = prev
    for t in range(1, len(raw_scale)):
        prev = 0.2 * prev + 0.8 * raw_scale[t]
        sm[t] = prev
    pp_deg_c = pp_deg * np.clip(sm, MIN_SCALE, MAX_SCALE)[:, None]

    # 7. loudness
    loud_ref = _loudness(mod_ref)
    loud_deg = _loudness(pp_deg_c)

    # 8. masked disturbance + asymmetry factor (original ref densities,
    # scaled deg densities — P.862 multiply_with_asymmetry_factor)
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    disturbance = np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))

    asym = ((pp_deg_c + 50.0) / (pp_ref + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    d_frame = _pseudo_lp(disturbance, 2.0)            # D_POW_F = 2
    da_frame = _pseudo_lp(disturbance * asym, 1.0)    # A_POW_F = 1

    # 9. frame emphasis by reference loudness, both channels capped at 45
    h = ((tot_ref_100 + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    d_sym = _lpq_weight(d_frame, 6.0, 2.0)            # D_POW_S/T = 6/2
    d_asym = _lpq_weight(da_frame, 6.0, 2.0)          # A_POW_S/T = 6/2

    raw = 4.5 - D_WEIGHT * d_sym - A_WEIGHT * d_asym
    raw = float(np.clip(raw, -0.5, 4.5))
    return float(_raw_pesq_to_mos_lqo(raw))
