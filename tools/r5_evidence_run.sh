#!/bin/bash
# The port's flagship r=5 evidence run on one card, the counterpart of the
# JAX package's scripts/r5_evidence_run.sh with its two phases encoded:
#
#   phase 1: cli.alignment_run, full_1chip, r 5, char_sec 0.06 with jitter
#            0.3, text length 20, B 32, 25,000 steps on 512 utterances;
#   phase 2: the same flags, --resume-from the run directory, 25,000 more
#            steps on 2,048 utterances (the first 512 are phase 1's);
#   then cli.audio_evidence (--no-dropout --char-sec 0.06) on the held-out
#   prompts and on the corpus prompts, and tools/trained_findings.py.
#
#   tools/r5_evidence_run.sh [LOG_DIR]      (default out/r5_evidence)
#
# Each phase is its own process; the run directory under
# artifacts/alignment_r5_torch_work/ carries the state between them (a
# checkpoint every 2,500 steps), so a phase cut short is run again with
# --resume-from. The three evidence directories land in
# artifacts/alignment_r5_torch, artifacts/audio_evidence_r5_torch and
# artifacts/audio_evidence_r5_torch_heldout; every log in LOG_DIR.
# PHASE_STEPS (default 25000) sets each phase's steps.
set -eu
cd "$(dirname "$0")/.."
export PYTHONPATH=$PWD
LOG=${1:-out/r5_evidence}
STEPS=${PHASE_STEPS:-25000}
WORK=artifacts/alignment_r5_torch_work
RUN=$WORK/run
mkdir -p "$LOG"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$LOG/card.txt"
COMMON=(--preset full_1chip --set model.r=5 --char-sec 0.06 --char-sec-jitter 0.3
        --text-len 20 --batch-size 32 --save-every 2500 --log-every 250
        --out artifacts/alignment_r5_torch --save-run "$RUN")

stage() {            # stage NAME COMMAND...: run, time and log one stage
  local name=$1; shift
  echo "$(date -u +%H:%M:%S) $name: start" | tee -a "$LOG/stages.log"
  local t0=$SECONDS
  "$@" > "$LOG/$name.log" 2>&1 || { tail -20 "$LOG/$name.log"; return 1; }
  echo "$(date -u +%H:%M:%S) $name: done after $((SECONDS - t0)) s" | tee -a "$LOG/stages.log"
  tail -3 "$LOG/$name.log"
}

stage phase1 python3 -m tacotron_tpu_torch.cli.alignment_run "${COMMON[@]}" \
    --n-utts 512 --steps "$STEPS"
stage phase2 python3 -m tacotron_tpu_torch.cli.alignment_run "${COMMON[@]}" \
    --n-utts 2048 --steps "$STEPS" --resume-from "$RUN"
stage audio_heldout python3 -m tacotron_tpu_torch.cli.audio_evidence --run-dir "$RUN" \
    --data-dir "$WORK/data" --out artifacts/audio_evidence_r5_torch_heldout \
    --no-dropout --char-sec 0.06
stage audio_corpus python3 -m tacotron_tpu_torch.cli.audio_evidence --run-dir "$RUN" \
    --data-dir "$WORK/data" --out artifacts/audio_evidence_r5_torch \
    --no-dropout --char-sec 0.06 --corpus-prompts
stage findings python3 tools/trained_findings.py --run-dir "$RUN" --data-dir "$WORK/data" \
    --out "$LOG/trained_findings.json"
echo "$(date -u +%H:%M:%S) done after $SECONDS s" | tee -a "$LOG/stages.log"
