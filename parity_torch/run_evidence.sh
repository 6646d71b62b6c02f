#!/bin/bash
# The port's accuracy evidence on one GPU, the runs behind PARITY_TORCH.md:
#
#   1. parity_run rgbd_geometric --rot-head-wide at the JAX script's defaults
#      (6 objects x 700 frames, 75-degree ball, lr 5e-4, patience 15,
#      batch 32, early stop at 97 % val ADD-0.1d, seed 0);
#   2. parity_run rgbd_geometric, the reference rotation head, same fixture;
#   3. parity_e2e --variants rgbd_geometric rgbd_geometric_widehead (YOLOv8n
#      5 epochs at 640, then eval_e2e on the test split);
#   4. probe_components on both runs;
#   5. the reference head again at SEEDS (default 1 and 2: the init, the
#      shuffle and the random draws; parity_run's --seed) on stage 1's
#      seed-0 fixture, each in WORKDIR/seed<N> with the fixture linked in.
#
# Usage, from the repository root:
#   bash parity_torch/run_evidence.sh [WORKDIR] [OUT] [STAGES] [SEEDS]
# WORKDIR (default /tmp/pose6d_torch_parity) holds the fixture and the
# weights; OUT (default parity_torch/card) receives the small files after
# each stage: results.json, each run's metrics.csv, e2e_results.json,
# probe_results.json, the tables and the logs, with the card's name and
# power limit. STAGES (default "1 2 3 4 5") picks stages; stage 5 needs
# stage 1's fixture; SEEDS (default "1 2") are stage 5's. A stage that
# fails does not stop the later ones; the script exits with the last
# failure's code.
set -euo pipefail
WD=${1:-/tmp/pose6d_torch_parity}
OUT=${2:-parity_torch/card}
STAGES=${3:-1 2 3 4 5}
SEEDS=${4:-1 2}
mkdir -p "$WD" "$OUT/logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/device.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
  | tee -a "$OUT/device.txt"

collect() {  # collect [SUBDIR]: the small files of WORKDIR[/SUBDIR] to OUT[/SUBDIR]
  local src="$WD/${1:-}" dst="$OUT/${1:-}"
  mkdir -p "$dst"
  for f in results.json e2e_results.json probe_results.json PARITY.md E2E.md PROBE.md \
           e2e_run.log; do
    if [ -f "$src/$f" ]; then cp "$src/$f" "$dst/"; fi
  done
  for d in "$src"/weights_*; do
    if [ -f "$d/metrics.csv" ]; then
      mkdir -p "$dst/$(basename "$d")"
      cp "$d/metrics.csv" "$dst/$(basename "$d")/"
    fi
  done
}

run() {  # run <stage name> <command...>: timed, logged, then the files collected
  local name=$1
  shift
  local t0=$SECONDS
  echo "=== $name: $*" | tee -a "$OUT/logs/stages.txt"
  set +e
  "$@" > "$OUT/logs/$name.log" 2>&1
  local rc=$?
  set -e
  echo "=== $name: rc $rc in $((SECONDS - t0)) s" | tee -a "$OUT/logs/stages.txt"
  tail -5 "$OUT/logs/$name.log"
  collect "${SUB:-}"
  return $rc
}

M="python -m pose6d_tpu_torch.cli"
failed=0
for s in $STAGES; do
  case $s in
    1) run parity_widehead $M.parity_run --workdir "$WD" --variants rgbd_geometric \
         --rot-head-wide || failed=$? ;;
    2) run parity_reference $M.parity_run --workdir "$WD" --variants rgbd_geometric \
         || failed=$? ;;
    3) run parity_e2e $M.parity_e2e --workdir "$WD" \
         --variants rgbd_geometric rgbd_geometric_widehead || failed=$? ;;
    4) run probe $M.probe_components --workdir "$WD" \
         --variants rgbd_geometric rgbd_geometric_widehead || failed=$? ;;
    5) for seed in $SEEDS; do
         SUB=seed$seed
         mkdir -p "$WD/$SUB"
         ln -sfn "$WD/synth" "$WD/$SUB/synth"
         run parity_reference_seed$seed $M.parity_run --workdir "$WD/$SUB" \
           --variants rgbd_geometric --seed $seed || failed=$?
         SUB=
       done ;;
    *) echo "unknown stage $s" >&2; exit 2 ;;
  esac
done
exit $failed
