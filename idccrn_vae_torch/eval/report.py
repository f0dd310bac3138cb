"""Per-SNR-bucket median reporting, the reference's published format.

The port's copy of `idccrn_vae_tpu/eval/report.py`.

The reference's only published quality evidence is per-SNR-bucket box
plots of SI-SDR / PESQ / ESTOI on DNS3 / WSJ0-QUT / VB-DMD
(the reference's results/*.png; medians transcribed in BASELINE.md).
This module reproduces that report shape from the eval runners'
per-utterance score files: for each bucket, the median enhanced score,
the median unprocessed-noisy score, and the median of PAIRED per-
utterance deltas (more robust than a difference of medians at the
small per-bucket n a demo corpus affords).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

#: Fixed series colors (colorblind-validated categorical slots; the
#: unprocessed-noisy baseline is neutral gray + hatched — identity never
#: rests on color alone). Order is load-bearing: assign by position.
_BASELINE_COLOR = "#6e6d68"
_SERIES_COLORS = ("#2a78d6", "#eb6834", "#1baf7a")  # blue/orange/aqua
_METRIC_LABELS = {"sisdr": "SI-SDR (dB)", "pesq": "PESQ (WB)",
                  "estoi": "ESTOI", "rmse": "RMSE"}


def bucketed_median_report(
    per_utt: Mapping[str, Mapping[str, float]],
    noisy_per_utt: Mapping[str, Mapping[str, float]],
    bucket_of: Mapping[str, str],
    bucket_order: Optional[Sequence[str]] = None,
) -> Dict[str, dict]:
    """Per-bucket medians of enhanced / noisy / paired-delta scores.

    per_utt / noisy_per_utt: utterance name -> {metric: value} (the
    runners' per_utterance.json / noisy_per_utterance.json contents).
    bucket_of: utterance name -> bucket label; utterances without a
    bucket are grouped under "(unbucketed)".

    Returns {bucket: {"n": int, metric: {"enhanced": med, "noisy": med,
    "delta": median of per-utt (enhanced - noisy)}}}, insertion-ordered
    by bucket_order (then any extra buckets, sorted).
    """
    groups: Dict[str, list] = {}
    for name, scores in per_utt.items():
        groups.setdefault(bucket_of.get(name, "(unbucketed)"),
                          []).append(name)
    order = [b for b in (bucket_order or []) if b in groups]
    order += sorted(b for b in groups if b not in order)

    report: Dict[str, dict] = {}
    for bucket in order:
        names = groups[bucket]
        row: dict = {"n": len(names)}
        metrics = sorted({k for n in names for k in per_utt[n]})
        for m in metrics:
            enh = np.array([per_utt[n][m] for n in names
                            if m in per_utt[n]], np.float64)
            paired = [(per_utt[n][m], noisy_per_utt[n][m]) for n in names
                      if m in per_utt[n]
                      and m in noisy_per_utt.get(n, {})]
            entry = {"enhanced": float(np.median(enh))}
            if paired:
                arr = np.array(paired, np.float64)
                entry["noisy"] = float(np.median(arr[:, 1]))
                entry["delta"] = float(np.median(arr[:, 0] - arr[:, 1]))
            row[m] = {k: round(v, 4) for k, v in entry.items()}
        report[bucket] = row
    return report


def format_bucket_table(report: Mapping[str, dict],
                        metrics: Sequence[str] = ("sisdr", "pesq",
                                                  "estoi")) -> str:
    """Plain-text table of a bucketed_median_report (noisy -> enhanced
    (delta) per metric per bucket), for logs and the E2E tool."""
    have = [m for m in metrics
            if any(m in row for row in report.values())]
    head = ["bucket", "n"] + [f"{m} noisy->enh (Δmed)" for m in have]
    lines = []
    for bucket, row in report.items():
        cells = [bucket, str(row.get("n", ""))]
        for m in have:
            e = row.get(m)
            if not e:
                cells.append("-")
            elif "noisy" in e:
                cells.append(f"{e['noisy']:.3f}->{e['enhanced']:.3f} "
                             f"({e['delta']:+.3f})")
            else:
                cells.append(f"{e['enhanced']:.3f}")
        lines.append(cells)
    widths = [max(len(r[i]) for r in [head] + lines)
              for i in range(len(head))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    return "\n".join(fmt.format(*r) for r in [head] + lines)


def plot_bucket_boxes(
    systems: Mapping[str, Mapping[str, Mapping[str, float]]],
    bucket_of: Mapping[str, str],
    out_png: str,
    metrics: Sequence[str] = ("sisdr", "pesq", "estoi"),
    bucket_order: Optional[Sequence[str]] = None,
    title: Optional[str] = None,
    baseline: Optional[str] = None,
) -> None:
    """Per-SNR-bucket box plots, one subplot per metric — the exact
    shape of the reference's published results figures
    (the reference's results/*_combined_metrics_large_font.png: grouped
    boxes per SNR bucket, one box per system).

    systems: ordered {system name -> per-utterance scores}. `baseline`
    names the unprocessed-input system (if present): it is drawn gray +
    hatched so the baseline reads without color — styling follows the
    NAME, never the position. Other systems take a fixed colorblind-
    validated color list by position (max 3 of them).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    names = list(systems)
    has_base = baseline in names
    if len(names) - int(has_base) > len(_SERIES_COLORS):
        raise ValueError(
            f"at most {len(_SERIES_COLORS)} non-baseline systems per "
            "figure (colorblind-safe palette cap) — facet instead")
    colors, series_it = {}, iter(_SERIES_COLORS)
    for n in names:
        colors[n] = _BASELINE_COLOR if n == baseline else next(series_it)

    buckets = [b for b in (bucket_order or [])
               if any(bucket_of.get(n) == b
                      for s in systems.values() for n in s)]
    if not buckets:
        buckets = sorted({bucket_of.get(n, "(unbucketed)")
                          for s in systems.values() for n in s})

    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(4.2 * len(metrics), 4.2))
    axes = np.atleast_1d(axes)
    n_sys = len(names)
    group_w = 0.8
    box_w = group_w / n_sys
    ink, muted = "#0b0b0b", "#52514e"
    for ax, metric in zip(axes, metrics):
        for si, name in enumerate(names):
            per_utt = systems[name]
            data, positions = [], []
            for bi, bucket in enumerate(buckets):
                vals = [v[metric] for n, v in per_utt.items()
                        if metric in v and bucket_of.get(n) == bucket]
                if vals:
                    data.append(vals)
                    positions.append(
                        bi + (si - (n_sys - 1) / 2) * box_w)
            if not data:
                continue
            c = colors[name]
            bp = ax.boxplot(
                data, positions=positions, widths=box_w * 0.85,
                patch_artist=True, medianprops={"color": ink,
                                                "linewidth": 1.4},
                whiskerprops={"color": c, "linewidth": 1.2},
                capprops={"color": c, "linewidth": 1.2},
                flierprops={"marker": ".", "markersize": 4,
                            "markerfacecolor": c,
                            "markeredgecolor": "none"})
            for box in bp["boxes"]:
                box.set(facecolor=c, alpha=0.55, edgecolor=c,
                        linewidth=1.2,
                        hatch="///" if name == baseline else None)
        ax.set_xticks(range(len(buckets)))
        ax.set_xticklabels(buckets, color=ink)
        ax.set_xlabel("SNR bucket (dB)", color=muted)
        ax.set_title(_METRIC_LABELS.get(metric, metric), color=ink)
        ax.grid(axis="y", color="#e4e3de", linewidth=0.8)
        ax.set_axisbelow(True)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        for spine in ("left", "bottom"):
            ax.spines[spine].set_color(muted)
        ax.tick_params(colors=muted)
    handles = [Patch(facecolor=colors[n], alpha=0.55,
                     edgecolor=colors[n],
                     hatch="///" if n == baseline else None, label=n)
               for n in names]
    fig.legend(handles=handles, loc="upper center",
               ncol=min(n_sys, 4), frameon=False,
               bbox_to_anchor=(0.5, 1.0 if not title else 0.96))
    if title:
        fig.suptitle(title, color=ink, y=1.0)
    fig.tight_layout(rect=(0, 0, 1, 0.90))
    fig.savefig(out_png, dpi=150, facecolor="#fcfcfb",
                bbox_inches="tight")
    plt.close(fig)
