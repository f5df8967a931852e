"""CLI: end-to-end audio evidence, the port of the JAX package's ``scripts/audio_evidence.py``.

    python -m tacotron_tpu_torch.cli.audio_evidence --run-dir RUN_DIR --data-dir DATA_DIR \\
        --out OUT [--n-prompts 8] [--text-len 20] [--char-sec 0.025] [--seed 123]
        [--corpus-prompts] [--no-dropout] [--steps 0] [--gl-iters 1000] [--platform cpu]

Synthesizes char-tone prompts from a trained run directory (one that
``cli.alignment_run --save-run`` wrote: ``config.json`` and checkpoints in
the JAX package's layout), decodes each wav back to characters
(``data/ljspeech.py::decode_char_tones``) and scores it against its prompt
with ``char_accuracy``, on the prompt-length prefix: there is no stop
token, so the fixed decode budget (1.6x the expected frames unless
``--steps``) runs past the content. The prompts are held out (random
strings from ``--seed``, no character twice in a row, so that tone runs
map one to one to characters) or, with ``--corpus-prompts``, the training
corpus's first ones without a doubled character. Writes ``OUT/utt_NN.wav``
and ``OUT/summary.json`` with the JAX script's keys (``backend``: the
card's name, or "cpu"). Synthesis is the port's ``Synthesizer`` (the
step-by-step decode, Griffin-Lim in the kernel's bf16 mode on the card).
It runs on the card unless ``--platform cpu``; without a card and without
that flag it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def held_out_prompts(n: int, text_len: int, alphabet_size: int, seed: int) -> list[str]:
    rs = np.random.default_rng(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz"[:alphabet_size]
    prompts = []
    for _ in range(n):
        chars = [str(rs.choice(list(alphabet)))]
        while len(chars) < text_len:
            c = str(rs.choice(list(alphabet)))
            if c != chars[-1]:
                chars.append(c)
        prompts.append("".join(chars))
    return prompts


def corpus_prompts(data_dir: str, n: int) -> list[str]:
    """The first ``n`` texts of the corpus beside ``data_dir`` (its
    ``../corpus/metadata.csv``) with no character twice in a row: the tone
    decoder merges a doubled character's runs."""
    prompts = []
    meta = os.path.join(os.path.dirname(data_dir.rstrip("/")), "corpus", "metadata.csv")
    with open(meta) as f:
        for line in f:
            text = line.strip().split("|")[1]
            if all(a != b for a, b in zip(text, text[1:])):
                prompts.append(text)
            if len(prompts) >= n:
                break
    return prompts


def decode_budget(text_len: int, char_sec: float, sample_rate: int, hop_length: int,
                  r: int) -> int:
    """Decoder steps: 1.6x the expected frame count of a prompt."""
    return int(1.6 * text_len * char_sec * sample_rate / hop_length / r)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run-dir", default="artifacts/alignment_full_work/run")
    p.add_argument("--data-dir", default="artifacts/alignment_full_work/data")
    p.add_argument("--out", default="artifacts/audio_evidence")
    p.add_argument("--n-prompts", type=int, default=8)
    p.add_argument("--text-len", type=int, default=20)
    p.add_argument("--alphabet-size", type=int, default=26)
    p.add_argument("--char-sec", type=float, default=0.025,
                   help="training corpus mean tone duration: sizes the decode-step budget")
    p.add_argument("--seed", type=int, default=123,
                   help="prompt seed; differs from the corpus seed, so prompts are held out")
    p.add_argument("--corpus-prompts", action="store_true",
                   help="draw prompts from the training corpus metadata instead of "
                        "sampling held-out strings (doubled characters skipped)")
    p.add_argument("--no-dropout", action="store_true",
                   help="zero prenet dropout for the synthesis pass")
    p.add_argument("--steps", type=int, default=0,
                   help="decoder steps; 0 = 1.6x the expected frame count")
    p.add_argument("--gl-iters", type=int, default=1000)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: the plain PyTorch versions on the CPU; by default the card")
    args = p.parse_args(argv)

    from tacotron_tpu_torch.cli.alignment_run import backend_name
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.data.ljspeech import char_accuracy, decode_char_tones, save_wav
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.runtime import resolve_device
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    device = resolve_device(PLATFORMS[args.platform] if args.platform else None)
    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if args.no_dropout:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, prenet_dropout=0.0))
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.json"))
    state = create_train_state(cfg, device=device)
    state, step = checkpoint.restore(os.path.join(args.run_dir, "ckpt"), state, cfg.train)
    print(f"restored checkpoint at step {step}")

    if args.corpus_prompts:
        prompts = corpus_prompts(args.data_dir, args.n_prompts)
    else:
        prompts = held_out_prompts(args.n_prompts, args.text_len, args.alphabet_size, args.seed)
    n_steps = args.steps or decode_budget(args.text_len, args.char_sec, cfg.audio.sample_rate,
                                          cfg.audio.hop_length, cfg.model.r)

    synth = Synthesizer(cfg, *split_state(state.model), vocab, device=device)
    del state
    out = synth(prompts, n_steps=n_steps, gl_iters=args.gl_iters)

    os.makedirs(args.out, exist_ok=True)
    rows = []
    for i, (prompt, wav) in enumerate(zip(prompts, out["wavs"])):
        # scored on the prompt-length prefix: the decode runs past the content
        hyp = decode_char_tones(wav, cfg.audio.sample_rate, args.alphabet_size)[: len(prompt)]
        acc = char_accuracy(prompt, hyp)
        save_wav(os.path.join(args.out, f"utt_{i:02d}.wav"), wav, cfg.audio.sample_rate)
        rows.append({"prompt": prompt, "decoded": hyp, "char_accuracy": round(acc, 4),
                     "wav": f"utt_{i:02d}.wav"})
        print(f"{prompt} -> {hyp}  acc {acc:.3f}")

    summary = {
        "checkpoint_step": step,
        "n_prompts": args.n_prompts,
        "text_len": args.text_len,
        "alphabet_size": args.alphabet_size,
        "prompt_seed": args.seed,
        "n_decode_steps": n_steps,
        "gl_iters": args.gl_iters,
        "prompt_source": "training-corpus" if args.corpus_prompts else "held-out",
        "prenet_dropout": cfg.model.prenet_dropout,
        "sample_rate": cfg.audio.sample_rate,
        "per_prompt": rows,
        "char_accuracy_mean": round(float(np.mean([r["char_accuracy"] for r in rows])), 4),
        "char_accuracy_min": round(float(np.min([r["char_accuracy"] for r in rows])), 4),
        "backend": backend_name(device),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in ("char_accuracy_mean", "char_accuracy_min")}))


if __name__ == "__main__":
    main()
