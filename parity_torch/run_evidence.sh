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
#      seed-0 fixture, each in WORKDIR/seed<N> with the fixture linked in;
#   6. symmetric objects: parity_run rgbd_geometric --rot-head-wide
#      --symmetric-objects in WORKDIR/sym (objects 1-6 and folders 10 and
#      11), then parity_symmetric (the per-object ADD / ADD-S of its best);
#   7. probe_rgbd_gradients at its defaults (img 64, batch 16, 10 steps);
#   8. selection_study over stages 1-2's runs with stage 3's detector, on
#      the test split (best, best_deploy, last);
#   9. the serving gates: eval_e2e float, int8, folded and folded through
#      the stem and stage 1-4 kernels for stages 1-2's runs, then serving_md;
#  10. multi-object frames: the held-out scene (objects 1-4, 120 frames,
#      seed 9) and two training scenes (objects 1-4 seed 11, 3-6 seed 13,
#      300 frames each) from generate_synthetic_scene; stage 3's detector
#      fine-tuned to 9 epochs at lr 1e-4 with --scene-roots; eval_e2e
#      --max-objects 4 with the base and the fine-tuned `last` detector;
#      the single-object regression gate; then multiobj_md;
#  11. the rgbd arms of the diagnosis at the JAX runs' budgets (ARMS: rgbd
#      100 epochs, widehead 75, noattn 200, zeroattn 150; parity_run
#      resumes a cut run), then parity_diagnosis;
#  12. parity_summarize, parity_report, parity_diagnosis: the document
#      WORKDIR/PARITY_RESULTS.md assembled from WORKDIR/sections/.
#
# Stages 8-10 need the weights of stages 1-3 in the same WORKDIR.
#
# Usage, from the repository root:
#   bash parity_torch/run_evidence.sh [WORKDIR] [OUT] [STAGES] [SEEDS] [ARMS]
# WORKDIR (default /tmp/pose6d_torch_parity) holds the fixture and the
# weights; OUT (default parity_torch/card) receives the small files after
# each stage: results.json, each run's metrics.csv, the JSON results, the
# tables, the sections and the assembled document, the logs, with the
# card's name and power limit. STAGES (default "1 2 3 4 5") picks stages;
# stage 5 needs stage 1's fixture; SEEDS (default "1 2") are stage 5's;
# ARMS (default "rgbd widehead noattn zeroattn") are stage 11's. A stage
# that fails does not stop the later ones; the script exits with the last
# failure's code.
set -euo pipefail
WD=${1:-/tmp/pose6d_torch_parity}
OUT=${2:-parity_torch/card}
STAGES=${3:-1 2 3 4 5}
SEEDS=${4:-1 2}
ARMS=${5:-rgbd widehead noattn zeroattn}
RUNS="rgbd_geometric rgbd_geometric_widehead"  # stages 1-2's runs: stages 8-10 deploy them
mkdir -p "$WD/logs" "$OUT/logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/device.txt" \
  > "$WD/device.txt"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
  | tee -a "$OUT/device.txt"

collect() {  # collect [SUBDIR]: the small files of WORKDIR[/SUBDIR] to OUT[/SUBDIR]
  local src="$WD/${1:-}" dst="$OUT/${1:-}"
  mkdir -p "$dst"
  for f in results.json e2e_results.json probe_results.json PARITY.md E2E.md PROBE.md \
           e2e_run.log selection_results.json rgbd_gradient_probe.json \
           symmetric_breakdown.json PARITY_RESULTS.md; do
    if [ -f "$src/$f" ]; then cp "$src/$f" "$dst/"; fi
  done
  if [ -d "$src/sections" ]; then
    mkdir -p "$dst/sections"
    cp "$src"/sections/*.md "$dst/sections/"
  fi
  for d in "$src"/weights_*; do
    if [ -f "$d/metrics.csv" ]; then
      mkdir -p "$dst/$(basename "$d")"
      cp "$d/metrics.csv" "$dst/$(basename "$d")/"
    fi
  done
}

run() {  # run <log name> <command...>: timed, logged to WORKDIR/logs and OUT/logs, then
  #           the files collected
  local name=$1
  shift
  local t0=$SECONDS
  echo "=== $name: $*" | tee -a "$OUT/logs/stages.txt"
  set +e
  "$@" > "$WD/logs/$name.log" 2>&1
  local rc=$?
  set -e
  cp "$WD/logs/$name.log" "$OUT/logs/"
  echo "=== $name: rc $rc in $((SECONDS - t0)) s" | tee -a "$OUT/logs/stages.txt"
  tail -5 "$WD/logs/$name.log"
  collect "${SUB:-}"
  return $rc
}

run_flags() {  # run_flags <run name>: eval_e2e's architecture flags of a parity_run name
  case $1 in *_widehead*) echo --rot-head-wide ;; esac
}

trained() {  # trained <run name>: true when WORKDIR holds its weights, else says so
  if [ -f "$WD/weights_$1/last.pt" ]; then return 0; fi
  echo "=== $1: no trained weights in $WD, skipped" | tee -a "$OUT/logs/stages.txt"
  return 1
}

eval_e2e() {  # eval_e2e <log name> <run name> <eval_e2e arguments...>
  local name=$1 runname=$2
  shift 2
  # shellcheck disable=SC2046
  run "$name" $M.eval_e2e --variant rgbd_geometric $(run_flags "$runname") \
    --mesh-dir "$WD/synth/models" --pose-weights "$WD/weights_$runname" "$@"
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
    6) SUB=sym
       run parity_symmetric_run $M.parity_run --workdir "$WD/sym" --variants rgbd_geometric \
         --rot-head-wide --symmetric-objects || failed=$?
       SUB=
       run parity_symmetric $M.parity_symmetric --workdir "$WD" --sym-workdir "$WD/sym" \
         || failed=$?
       collect sym ;;
    7) run probe_rgbd_gradients $M.probe_rgbd_gradients --workdir "$WD" || failed=$? ;;
    8) # shellcheck disable=SC2086
       run selection $M.selection_study --workdir "$WD" --variants $RUNS || failed=$? ;;
    9) for r in $RUNS; do
         trained "$r" || continue
         for mode in float int8 folded folded_kernels; do
           case $mode in
             float) flags=() ;;
             int8) flags=(--int8-backbone) ;;
             folded) flags=(--folded-backbone) ;;
             folded_kernels) flags=(--folded-backbone --folded-stem --folded-stages 1,2,3,4) ;;
           esac
           eval_e2e "e2e_${mode}_$r" "$r" --data-root "$WD/synth/data" \
             --yolo-weights "$WD/yolo" --split test "${flags[@]}" || failed=$?
         done
       done
       # shellcheck disable=SC2086
       run serving_md $M.serving_md --workdir "$WD" --variants $RUNS || failed=$? ;;
    10) run scenes python -c "
import os, sys
from pose6d_tpu_torch.data.synthetic import generate_synthetic_scene, recover_object_colors
wd = sys.argv[1]
colors = recover_object_colors(os.path.join(wd, 'synth', 'data'))
for name, ids, frames, seed in (('synth_scene', (1, 2, 3, 4), 120, 9),
                                ('synth_scene_tr_a', (1, 2, 3, 4), 300, 11),
                                ('synth_scene_tr_b', (3, 4, 5, 6), 300, 13)):
    root = os.path.join(wd, name)
    if os.path.isdir(os.path.join(root, 'data', '01')):
        print(root, 'exists, kept')
        continue
    generate_synthetic_scene(root, {k: colors[k] for k in ids}, frames=frames, seed=seed,
                             max_angle_deg=75.0, write_models=False)
    print('wrote', root, 'objects', ids, 'seed', seed, 'frames', frames)
" "$WD" || failed=$?
        rm -rf "$WD/yolo_ft"
        cp -r "$WD/yolo" "$WD/yolo_ft"
        if run yolo_ft $M.train_yolo --data-root "$WD/synth/data" --save-dir "$WD/yolo_ft" \
             --scene-roots "$WD/synth_scene_tr_a/data,$WD/synth_scene_tr_b/data" \
             --epochs 9 --lr 1e-4; then
          for r in $RUNS; do
            trained "$r" || continue
            multi=(--max-objects 4 --classes 1,2,3,4,5,6 --split train
                   --data-root "$WD/synth_scene/data")
            eval_e2e "e2e_multiobj_base_$r" "$r" --yolo-weights "$WD/yolo" "${multi[@]}" \
              || failed=$?
            eval_e2e "e2e_multiobj_ftlast_$r" "$r" --yolo-weights "$WD/yolo_ft" \
              --yolo-checkpoint last "${multi[@]}" || failed=$?
            eval_e2e "e2e_ftlast_singleobj_$r" "$r" --yolo-weights "$WD/yolo_ft" \
              --yolo-checkpoint last --data-root "$WD/synth/data" --split test || failed=$?
          done
          # shellcheck disable=SC2086
          run multiobj_md $M.multiobj_md --workdir "$WD" --variants $RUNS || failed=$?
        else
          failed=$?
          echo "=== the fine-tune failed: stage 10's evals skipped" | tee -a "$OUT/logs/stages.txt"
        fi ;;
    11) for arm in $ARMS; do
          case $arm in
            rgbd) args=(--epochs 100) ;;
            widehead) args=(--epochs 75 --rot-head-wide) ;;
            noattn) args=(--epochs 200 --no-fusion-attention) ;;
            zeroattn) args=(--epochs 150 --attn-zero-init) ;;
            *) echo "unknown arm $arm" >&2; exit 2 ;;
          esac
          run "parity_rgbd_$arm" $M.parity_run --workdir "$WD" --variants rgbd "${args[@]}" \
            || failed=$?
        done
        run parity_diagnosis $M.parity_diagnosis --workdir "$WD" || failed=$? ;;
    12) run parity_summarize $M.parity_summarize --workdir "$WD" || failed=$?
        run parity_report $M.parity_report --workdir "$WD" || failed=$?
        run parity_diagnosis $M.parity_diagnosis --workdir "$WD" || failed=$? ;;
    *) echo "unknown stage $s" >&2; exit 2 ;;
  esac
done
exit $failed
