"""Generate the speech-like synthetic evaluation corpus from the CLI.

The port's copy of `idccrn_vae_tpu/cli/make_synth_corpus.py`; the same
flags and seed write the same corpus.

The reference evaluates on corpora that are not redistributable (DNS3 /
WSJ0-QUT / VB-DMD); `data/synth.py` generates a formant-trajectory
source-filter surrogate with real silences, stationary/nonstationary
noise, and DNS3-style SNR buckets assigned round-robin so per-bucket
medians (eval/report.py) are computed over balanced groups. This CLI
exposes the generator directly so a user can build train/val corpora.

Layout written under --out (DNS companion naming, data/segments.py):
  {clean,noise,noisy}_{train,val}/..._fileid_<i>.wav + corpus_meta.json
"""

from __future__ import annotations

import argparse

from idccrn_vae_torch.data.synth import FS, SNR_BUCKETS, make_corpus


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, required=True,
                   help="corpus root directory (created if missing)")
    p.add_argument("--n_train", type=int, default=96)
    p.add_argument("--n_val", type=int, default=24,
                   help="use a multiple of the bucket count (default 4 "
                        "buckets) for balanced per-bucket groups")
    p.add_argument("--utt_seconds", type=float, default=6.5)
    p.add_argument("--fs", type=int, default=FS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr_lo", type=float, default=None,
                   help="override: single [snr_lo, snr_hi) bucket "
                        "instead of the DNS3-style 0-20 dB buckets")
    p.add_argument("--snr_hi", type=float, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.snr_lo is None) != (args.snr_hi is None):
        raise SystemExit("--snr_lo and --snr_hi must be given together")
    buckets = (SNR_BUCKETS if args.snr_lo is None
               else ((args.snr_lo, args.snr_hi),))
    dirs, meta = make_corpus(args.out, args.n_train, args.n_val,
                             utt_seconds=args.utt_seconds, fs=args.fs,
                             buckets=buckets, seed=args.seed)
    n_files = len(meta["files"])
    print(f"wrote {n_files} noisy utterances ({args.n_train} train / "
          f"{args.n_val} val) under {args.out}; buckets: "
          f"{', '.join(meta['buckets'])}")
    for k in sorted(dirs):
        print(f"  {k}: {dirs[k]}")


if __name__ == "__main__":
    main()
