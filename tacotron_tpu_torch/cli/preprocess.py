"""CLI: offline data prep, the port of the JAX package's ``cli/preprocess.py``.

    python -m tacotron_tpu_torch.cli.preprocess --corpus-dir /path/LJSpeech-1.1 \\
        --data-dir data/ljspeech [--preset full_1chip] [--limit N] [--synthetic N] \\
        [--platform cpu]

Writes the packed data directory (``data/ljspeech.py``) that either
package's loader reads, with the features computed on the card, or on the
CPU with ``--platform cpu``; without a card and without that flag it
raises. Prints one JSON line with the same keys as the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import time

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus-dir", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--preset", default="full_1chip")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--format", default="ljspeech",
                   choices=["ljspeech", "vctk", "arctic", "blizzard"],
                   help="corpus layout (the reference shipped loaders for "
                        "Nancy/Blizzard, ARCTIC, VCTK; LJSpeech is primary)")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate an N-utterance synthetic corpus first (tests/demo)")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: compute the features on the CPU; by default the card")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (audio fields determine the "
                        "extracted features). Frame-geometry fields validate "
                        "as a trio, e.g. --set audio.n_fft=1024 --set "
                        "audio.win_length=960 --set audio.hop_length=240")
    args = p.parse_args(argv)

    from tacotron_tpu_torch.config import apply_overrides, get_config
    from tacotron_tpu_torch.data import ljspeech
    from tacotron_tpu_torch.runtime import resolve_device

    device = resolve_device(PLATFORMS[args.platform] if args.platform else None)
    cfg = apply_overrides(get_config(args.preset), args.overrides)
    if args.synthetic:
        ljspeech.generate_synthetic_corpus(
            args.corpus_dir, n=args.synthetic, sample_rate=cfg.audio.sample_rate
        )
    t0 = time.time()
    stats = ljspeech.preprocess(args.corpus_dir, args.data_dir, cfg.audio,
                                limit=args.limit, chunk=args.chunk,
                                fmt=args.format, device=device)
    stats["seconds"] = round(time.time() - t0, 2)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
