#!/bin/bash
# The port's whole dry-run sweep: every arch x shape x mesh cell of
# repro_torch.launch.dryrun, JOBS processes at a time (one CPU thread
# each; the slow train cells first), then both roofline tables.
#   bash tools/dryrun_sweep.sh OUT_DIR [JOBS]
# writes OUT_DIR/dryrun_torch/*.json, OUT_DIR/roofline_pod16x16.md and
# OUT_DIR/roofline_pod2x16x16.md.
set -e
cd "$(dirname "$0")/.."
out=${1:?usage: tools/dryrun_sweep.sh OUT_DIR [JOBS]}
jobs=${2:-8}
mkdir -p "$out/dryrun_torch"
start=$(date +%s)
for s in train_4k prefill_32k decode_32k long_500k; do
  for m in pod multipod; do
    for a in qwen2-72b mixtral-8x7b phi3.5-moe-42b-a6.6b phi3-medium-14b \
        deepseek-7b rwkv6-7b zamba2-1.2b phi-3-vision-4.2b whisper-medium \
        gemma3-1b; do
      echo "$a $s $m"
    done
  done
done | xargs -P "$jobs" -n 3 sh -c 'python3 -c "import sys; sys.path.insert(0, \"src\"); import torch; torch.set_num_threads(1); from repro_torch.launch.dryrun import main; main([\"--arch\", \"$0\", \"--shape\", \"$1\", \"--mesh\", \"$2\", \"--force\"])" 2>&1 | grep -E "^\[" | cut -c1-300' || true
echo "sweep seconds: $(( $(date +%s) - start ))"
cp results/dryrun_torch/*.json "$out/dryrun_torch/"
PYTHONPATH=src python3 -m repro_torch.launch.roofline > "$out/roofline_pod16x16.md"
PYTHONPATH=src python3 -m repro_torch.launch.roofline --mesh pod2x16x16 \
  > "$out/roofline_pod2x16x16.md"
