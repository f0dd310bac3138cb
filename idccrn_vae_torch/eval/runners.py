"""Evaluation runners: the reference's four test_*.py scripts as a
library (test_prevae, test_nsvae_se, test_se_cvaefinetune,
supervised_dccrn/test).

The port of `idccrn_vae_tpu/eval/runners.py`. Shared shape: iterate a
test set, run the batched device pipeline, score with EvalMetrics on the
host, write per-utterance JSON + a summary log with mean/median ± CI
(test_nsvae_se.py:504-570), optionally write enhanced wavs and latent
diagnostics. Utterances run length-sorted and batched, each batch padded
to one bucket (`bucket_pad_length`), in the JAX runners' order: the same
`np.argsort` call, the same buckets and the same real-frame trims of the
latents, so the same noise stream gives the same draws in the same
order.

Differences from the JAX runners:
  * the models are port modules holding their weights, so the VAE and
    supervised runners take loaded modules rather than (model,
    variables) pairs, and run plain calls where JAX keeps a per-length
    `jax.jit` cache;
  * randomness comes from one `torch.Generator` advanced through the
    batches (`generator=`, seed 0 on the model's device by default)
    where JAX splits one PRNG key per batch;
  * without matplotlib the VAE runner skips the cov(mu) figure and logs
    that it did (eval/diagnostics.py says why); every number is still
    written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from idccrn_vae_torch.data.audio_io import read_wav, resample, write_wav
from idccrn_vae_torch.eval.enhance import _sample_mean, bucket_pad_length
from idccrn_vae_torch.eval.metrics import (
    EvalMetrics,
    compute_mean,
    compute_median,
    metric_provenance,
)
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.utils.logger import get_logger

METRIC_NAMES = ("rmse", "sisdr", "pesq", "estoi")


def _log_provenance(logger) -> dict:
    """Tag + log which implementation produced pesq/stoi scores; every
    runner summary carries this so numbers from different installs are
    never silently conflated."""
    prov = metric_provenance()
    logger.info("metric provenance: pesq_impl=%s stoi_impl=%s",
                prov["pesq_impl"], prov["stoi_impl"])
    return prov


def _attach_bucket_report(result, out_dir, bucket_of, bucket_order,
                          logger) -> None:
    """Per-SNR-bucket median table (eval/report.py — the reference's
    published report format) appended to the result + written to
    <out_dir>/bucket_report.json. Deltas appear when the result carries
    noisy per-utterance scores; otherwise rows are enhanced-only.

    Score keys may be utt_names-DISAMBIGUATED ('parent__name.wav' /
    'name__2.wav') while corpus metas key bare basenames — resolved
    here so the report doesn't silently collapse to '(unbucketed)'."""
    from idccrn_vae_torch.eval.report import (
        bucketed_median_report,
        format_bucket_table,
    )

    def lookup(name):
        if name in bucket_of:
            return bucket_of[name]
        cand = name.split("__", 1)[-1]  # strip parent-dir prefix
        if cand in bucket_of:
            return bucket_of[cand]
        stem, ext = os.path.splitext(cand)  # strip __N dup suffix
        return bucket_of.get(stem.rsplit("__", 1)[0] + ext)

    resolved = {n: b for n in result["per_utterance"]
                if (b := lookup(n)) is not None}
    if bucket_of and not resolved:
        logger.warning(
            "no utterance matched the corpus meta's bucket keys — "
            "bucket report will be '(unbucketed)' only")
    rep = bucketed_median_report(
        result["per_utterance"], result.get("noisy_per_utterance", {}),
        resolved, bucket_order)
    result["per_snr_bucket"] = rep
    logger.info("== per-SNR-bucket medians ==\n%s",
                format_bucket_table(rep))
    with open(os.path.join(out_dir, "bucket_report.json"), "w") as f:
        json.dump(rep, f, indent=1)


def utt_names(paths: Sequence[str]) -> List[str]:
    """Per-utterance display/output names. Basenames when unique;
    duplicated basenames (find_wavs walks recursively, so per-speaker
    subdirs can repeat file names) are disambiguated with their parent
    directories — otherwise per-utt dicts silently collapse scores and
    enhanced wavs overwrite each other."""
    names = [os.path.basename(p) for p in paths]
    if len(set(names)) == len(names):
        return names
    dupes = {n for n in names if names.count(n) > 1}
    out = [f"{os.path.basename(os.path.dirname(os.path.abspath(p)))}__{n}"
           if n in dupes else n
           for p, n in zip(paths, names)]
    # parent prefix may not suffice (same name, same dir name) — force
    # uniqueness with an index suffix
    seen: Dict[str, int] = {}
    final = []
    for n in out:
        if n in seen:
            seen[n] += 1
            stem, ext = os.path.splitext(n)
            final.append(f"{stem}__{seen[n]}{ext}")
        else:
            seen[n] = 0
            final.append(n)
    return final


def load_testset(paths: Sequence[str], fs: int = 16000) -> List[np.ndarray]:
    """Load + resample wavs to the model rate (test_nsvae_se.py:235-238)."""
    wavs = []
    for p in paths:
        x, fs_x = read_wav(p)
        if x.ndim > 1:
            x = x[:, 0]
        if fs_x != fs:
            x = resample(x, fs_x, fs)
        wavs.append(x.astype(np.float32))
    return wavs


def summarize_scores(per_utt: Dict[str, Dict[str, float]], logger) -> dict:
    """Mean/median ± CI per metric, logged in the reference's format."""
    summary = {}
    if not per_utt:
        return summary
    keys = next(iter(per_utt.values())).keys()
    for k in keys:
        vals = np.array([v[k] for v in per_utt.values()], np.float64)
        mean, mci = compute_mean(vals)
        med, dci = compute_median(vals)
        summary[k] = {"mean": mean, "mean_ci": mci,
                      "median": float(med), "median_ci": float(dci)}
        logger.info("%s: mean %.4f ± %.4f | median %.4f ± %.4f",
                    k, mean, mci, med, dci)
    return summary


def score_pairs(est_list, ref_list, names, fs: int = 16000,
                metric: str = "all",
                workers: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """Score (est, ref) pairs; order-stable. Scoring is host-side numpy
    (native PESQ dominates), so on multi-core hosts the pairs are scored
    on a thread pool (EvalMetrics is stateless; the heavy numpy kernels
    drop the GIL). workers=None -> min(8, cpu_count)."""
    ev = EvalMetrics(metric)

    def one(args):
        est, ref, name = args
        out = ev.eval(est, ref, fs, name)
        if metric == "all":
            return name, dict(zip(METRIC_NAMES, map(float, out)))
        return name, {metric: float(out)}

    items = list(zip(est_list, ref_list, names))
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if workers <= 1 or len(items) <= 1:
        return dict(map(one, items))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as ex:
        return dict(ex.map(one, items))


def _bucketed(wavs: Sequence[np.ndarray], batch_size: int, hop: int):
    """The JAX runners' batching: sorted by length (this exact argsort
    call: its default sort is not stable, and ties must break the same
    way), batch_size at a time, each batch zero-padded to one bucket.
    Yields (indices into wavs, (b, bucket) float32 batch)."""
    order = np.argsort([len(w) for w in wavs])
    i = 0
    while i < len(order):
        chunk = order[i : i + batch_size]
        max_len = max(len(wavs[j]) for j in chunk)
        batch = np.zeros((len(chunk), bucket_pad_length(max_len, hop)),
                         np.float32)
        for r, j in enumerate(chunk):
            batch[r, : len(wavs[j])] = wavs[j]
        yield chunk, batch
        i += batch_size


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def run_enhancement_eval(
    enhancer,
    noisy_paths: Sequence[str],
    clean_paths: Sequence[str],
    out_dir: str,
    fs: int = 16000,
    batch_size: int = 8,
    write_wavs: bool = False,
    report_noisy_baseline: bool = True,
    latent_diagnostics: bool = False,
    logger=None,
    generator: Optional[torch.Generator] = None,
    bucket_of=None,
    bucket_order=None,
) -> dict:
    """SE evaluation (test_nsvae_se.py run / test_se_cvaefinetune run).

    Writes <out_dir>/per_utterance.json + summary in log + optionally
    enhanced wavs; reports deltas vs the unprocessed noisy input like
    test_se_cvaefinetune. With `bucket_of` (utterance name -> SNR
    bucket label, e.g. from a corpus_meta.json) also writes the
    per-bucket median table. `generator` drives the latent draws
    (`Enhancer.enhance_utterances`; seed 0 when None). In a data-parallel
    group every rank enhances its share of each batch, and rank 0 alone
    scores, writes and returns the result (the others return None).
    """
    noisy = load_testset(noisy_paths, fs)
    clean = load_testset(clean_paths, fs)
    names = utt_names(noisy_paths)

    enhanced = enhancer.enhance_utterances(noisy, batch_size=batch_size,
                                           generator=generator)
    if not distributed.is_primary():
        return None  # a data-parallel rank: rank 0 scores and writes
    os.makedirs(out_dir, exist_ok=True)
    logger = logger or get_logger(os.path.join(out_dir, "log.txt"), 1)
    per_utt = score_pairs(enhanced, clean, names, fs)
    logger.info("== enhanced vs clean ==")
    summary = summarize_scores(per_utt, logger)

    result = {"per_utterance": per_utt, "summary": summary,
              "provenance": _log_provenance(logger)}
    if report_noisy_baseline:
        noisy_scores = score_pairs(noisy, clean, names, fs)
        logger.info("== noisy (unprocessed) vs clean ==")
        noisy_summary = summarize_scores(noisy_scores, logger)
        result["noisy_per_utterance"] = noisy_scores
        result["noisy_summary"] = noisy_summary
        result["delta"] = {
            k: {"mean": summary[k]["mean"] - noisy_summary[k]["mean"]}
            for k in summary
        }
        # persisted so per-condition reports (eval/report.py SNR-bucket
        # medians) can pair enhanced and noisy scores per utterance
        with open(os.path.join(out_dir, "noisy_per_utterance.json"),
                  "w") as f:
            json.dump(noisy_scores, f, indent=1)
    if bucket_of:
        _attach_bucket_report(result, out_dir, bucket_of, bucket_order,
                              logger)

    if latent_diagnostics:
        from idccrn_vae_torch.eval.diagnostics import (
            latent_silhouette,
            mu_covariance,
        )

        speech_mus, noise_mus = enhancer.encode_latents(noisy)
        diag = {
            k: v.tolist() if hasattr(v, "tolist") else v
            for k, v in mu_covariance(speech_mus).items()
            if not k.startswith("cov_")
        }
        if noise_mus:
            sil = latent_silhouette(speech_mus, noise_mus)
            diag["silhouette_speech_vs_noise"] = sil
            logger.info("latent silhouette (speech vs noise): %s", sil)
        result["latent_diag"] = diag

    with open(os.path.join(out_dir, "per_utterance.json"), "w") as f:
        json.dump(per_utt, f, indent=1)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(result if "delta" in result
                  else {**summary, "provenance": result["provenance"]},
                  f, indent=1, default=float)

    if write_wavs:
        wav_dir = os.path.join(out_dir, "enhanced")
        os.makedirs(wav_dir, exist_ok=True)
        for name, est in zip(names, enhanced):
            try:
                write_wav(os.path.join(wav_dir, name), est, fs)
            except Exception as e:  # pragma: no cover
                logger.warning("failed writing %s: %s", name, e)
    return result


def run_vae_reconstruction_eval(
    encoder,
    decoder,
    wav_paths: Sequence[str],
    out_dir: str,
    cfg,
    num_samples: int = 10,
    fs: int = 16000,
    batch_size: int = 8,
    logger=None,
    plot: bool = True,
    write_wavs: bool = False,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """VAE reconstruction eval + latent diagnostics (test_prevae.py run).

    Reconstructs each utterance through encoder->decoder (loaded port
    `VaeEncoder` / `VaeDecoder`; sample-mean over num_samples draws from
    `generator`, seed 0 when None), scores vs the original, and dumps
    cov(mu) diagnostics + plot; write_wavs saves the reconstructions
    (test_prevae.py --save_outfiles).
    """
    from idccrn_vae_torch.eval.diagnostics import (
        mu_covariance,
        plot_cov_diagonals,
    )

    os.makedirs(out_dir, exist_ok=True)
    logger = logger or get_logger(os.path.join(out_dir, "log.txt"), 1)
    wavs = load_testset(wav_paths, fs)
    names = utt_names(wav_paths)
    device = _device_of(encoder)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    hop = cfg.stft.hop
    mus = []
    results: List[Optional[np.ndarray]] = [None] * len(wavs)
    for chunk, batch in _bucketed(wavs, batch_size, hop):
        with torch.inference_mode():
            out = encoder(torch.from_numpy(batch).to(device),
                          num_samples=num_samples, generator=generator)
            recon, _p = decoder(out.stft_x, out.z, out.skips,
                                num_samples=num_samples)
            rec = _sample_mean(recon, num_samples).float().cpu().numpy()
            mu = torch.stack([out.gauss.mu_r, out.gauss.mu_i],
                             dim=-1).float().cpu().numpy()
        for r, j in enumerate(chunk):
            n = min(len(wavs[j]), rec.shape[1])
            results[j] = rec[r, :n]
            # real frame count only — padded-silence frames would bias
            # the cov(mu) diagnostics
            mus.append(mu[r][: len(wavs[j]) // hop + 1])

    per_utt = score_pairs(results, wavs, names, fs)
    logger.info("== VAE reconstruction vs original ==")
    summary = summarize_scores(per_utt, logger)
    prov = _log_provenance(logger)
    diag = mu_covariance(mus)
    logger.info("cov(mu) offdiag mean abs: real %.5f imag %.5f",
                diag["offdiag_mean_abs_real"], diag["offdiag_mean_abs_imag"])
    if plot:
        try:
            plot_cov_diagonals(diag, os.path.join(out_dir, "cov_mu_diag.png"))
        except ImportError:
            logger.info("matplotlib is not installed: cov_mu_diag.png "
                        "skipped (its numbers are in summary.json)")
    with open(os.path.join(out_dir, "per_utterance.json"), "w") as f:
        json.dump(per_utt, f, indent=1)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"summary": summary, "provenance": prov,
                   "latent_diag": {k: (v.tolist() if hasattr(v, "tolist")
                                       else v)
                                   for k, v in diag.items()
                                   if not k.startswith("cov_")}},
                  f, indent=1)
    if write_wavs:
        wav_dir = os.path.join(out_dir, "recon")
        os.makedirs(wav_dir, exist_ok=True)
        for name, rec in zip(names, results):
            write_wav(os.path.join(wav_dir, name), rec, fs)
    return {"per_utterance": per_utt, "summary": summary,
            "provenance": prov,
            "latent_diag": {k: v for k, v in diag.items()
                            if not k.startswith("cov_")}}


def run_supervised_eval(model, noisy_paths, clean_paths, out_dir,
                        cfg, fs: int = 16000, batch_size: int = 8,
                        latent_diagnostics: bool = True,
                        write_wavs: bool = False,
                        logger=None, bucket_of=None,
                        bucket_order=None) -> dict:
    """Supervised DCCRN eval (supervised_dccrn/test.py, WITHOUT the
    reference's debug `idx > 5: break` truncation) of a loaded port
    `SupervisedDccrn`, including the bottleneck-latent covariance
    diagnostics the reference computes from `model.latent`; write_wavs
    saves the enhanced outputs (the reference's --save_output)."""
    os.makedirs(out_dir, exist_ok=True)
    logger = logger or get_logger(os.path.join(out_dir, "log.txt"), 1)
    noisy = load_testset(noisy_paths, fs)
    clean = load_testset(clean_paths, fs)
    names = utt_names(noisy_paths)
    device = _device_of(model)

    hop = cfg.stft.hop
    results: List[Optional[np.ndarray]] = [None] * len(noisy)
    latents = []
    for chunk, batch in _bucketed(noisy, batch_size, hop):
        with torch.inference_mode():
            out, _pred, lat = model(torch.from_numpy(batch).to(device),
                                    return_latent=True)
            out = out.float().cpu().numpy()
            lat = lat.float().cpu().numpy()
        for r, j in enumerate(chunk):
            n = min(len(noisy[j]), out.shape[1])
            results[j] = out[r, :n]
            h = lat.shape[-1] // 2
            # real frame count only — padded-silence frames would bias
            # the cov diagnostics (same trim as the VAE/enhance runners)
            frames = len(noisy[j]) // hop + 1
            latents.append(np.stack([lat[r, :frames, :h],
                                     lat[r, :frames, h:]], -1))

    per_utt = score_pairs(results, clean, names, fs)
    logger.info("== supervised DCCRN vs clean ==")
    summary = summarize_scores(per_utt, logger)
    result = {"per_utterance": per_utt, "summary": summary,
              "provenance": _log_provenance(logger)}
    if latent_diagnostics:
        from idccrn_vae_torch.eval.diagnostics import mu_covariance

        diag = mu_covariance(latents)
        logger.info("bottleneck latent cov offdiag |mean|: real %.5f "
                    "imag %.5f", diag["offdiag_mean_abs_real"],
                    diag["offdiag_mean_abs_imag"])
        result["latent_diag"] = {k: v.tolist() if hasattr(v, "tolist") else v
                                 for k, v in diag.items()
                                 if not k.startswith("cov_")}
    if bucket_of:
        # no noisy baseline in the supervised runner (reference parity:
        # supervised_dccrn/test.py scores enhanced only) -> rows are
        # enhanced-only medians
        _attach_bucket_report(result, out_dir, bucket_of, bucket_order,
                              logger)
    with open(os.path.join(out_dir, "per_utterance.json"), "w") as f:
        json.dump(per_utt, f, indent=1)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({k: v for k, v in result.items()
                   if k != "per_utterance"}, f, indent=1)
    if write_wavs:
        wav_dir = os.path.join(out_dir, "enhanced")
        os.makedirs(wav_dir, exist_ok=True)
        for name, est in zip(names, results):
            write_wav(os.path.join(wav_dir, name), est, fs)
    return result
