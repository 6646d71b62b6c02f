"""The whole system's evaluation, detector in the loop (counterpart of
scripts/eval_e2e.py): trained detector -> crop on the card -> pose net,
against the ground truth of a split: detection rate, class accuracy and
ADD / ADD-S / ADD-0.1d. The reference evaluates its pose nets on
ground-truth crops only.

  python -m pose6d_tpu_torch.cli.eval_e2e --variant rgbd_geometric \\
      --data-root .../data --mesh-dir .../models \\
      --yolo-weights runs/detect/linemod_yolo --pose-weights weights_rgbd_geometric

--folded-backbone serves the deployed bf16 configuration (BatchNorm folded
into the towers); with it --folded-stem, --folded-pallas and
--folded-stages run the stem, layer1 and the named stages as the CUDA
kernels (img 224). --int8-backbone calibrates the int8 towers and detector
on the first batch. The last line gives the evaluation's frames/s by the
host clock, from the first batch's PNG decoding to the last batch's
metrics (loading the checkpoints, folding and parsing the meshes excluded).
"""

import argparse
import sys
import time

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg, read_depth_m
from pose6d_tpu_torch.data.png import read_png


def _gt_quat(rot_mat) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(rot_mat).as_quat()


def _load_frames(paths, need_depth):
    frames, depths = [], []
    for img_path, depth_path in paths:
        frames.append(read_png(img_path))
        depths.append(read_depth_m(depth_path if need_depth else None, frames[-1].shape[:2]))
    return np.stack(frames), np.stack(depths)


def _gt_arrays(chunk):
    """A batch of samples' ground truth: quaternions (_gt_quat), translations
    in metres, object ids, and the intrinsics [B, 3, 3]."""
    gt_q = np.asarray([_gt_quat(s.rot_mat) for s in chunk], np.float32)
    gt_t = np.asarray([s.trans_mm / 1000.0 for s in chunk], np.float32)
    gt_ids = np.asarray([s.obj_id for s in chunk], np.int64)
    K = np.stack([s.cam_K for s in chunk]).astype(np.float32)
    return gt_q, gt_t, gt_ids, K


def _score_batch(out, evaluator, gt_q, gt_t, gt_ids, cls_to_objid, tot) -> None:
    """Add a batch's detections, class matches and ADD metrics (the
    undetected frames masked) to the running totals `tot`; reads the
    request's outputs back from the card."""
    det_valid = out["det_valid"].cpu().numpy()
    pred_obj = np.asarray([cls_to_objid.get(int(c), -1) for c in out["class_id"].cpu()])
    tot["detected"] += int(det_valid.sum())
    tot["cls_correct"] += int(((pred_obj == gt_ids) & det_valid).sum())
    tot["n"] += len(gt_ids)
    m = evaluator.eval_metrics(out["rotation"], out["translation"], gt_q, gt_t,
                               np.where(det_valid, gt_ids, -1))
    tot["add"] += m["add_mean"]
    tot["add_s"] += m["add_s_mean"]
    tot["acc"] += m["add_01d_acc"]
    tot["n_batches"] += 1


def _eval_multi(args, frames_idx, pipe, evaluator, cls_to_objid):
    """Multi-object frames (--max-objects > 1): each ground-truth object
    claims the best-scoring unused detection of its class (detections come
    score-ordered); an unmatched object counts as incorrect in the
    full-system ADD-0.1d. Matched pairs are evaluated in padded chunks
    (obj_id -1 masked), weighted by their counts."""
    M, B = args.max_objects, args.batch_size
    need_depth = args.variant.startswith("rgbd")
    total_gt = 0
    matched_q, matched_t, matched_gq, matched_gt_t, matched_ids = [], [], [], [], []
    calibrated = not args.int8_backbone
    for start in range(0, len(frames_idx), B):
        chunk = frames_idx[start:start + B]
        frames, depths = _load_frames([(fr.img_path, fr.depth_path) for fr in chunk], need_depth)
        K = np.stack([fr.cam_K for fr in chunk]).astype(np.float32)
        if not calibrated:
            pipe.quantize_backbones(frames, K, depths, include_detector=True)
            calibrated = True
        out = pipe(frames, K, depths)
        det_valid = out["det_valid"].cpu().numpy()
        pred_cls = out["class_id"].cpu().numpy()
        pred_q = out["rotation"].float().cpu().numpy()
        pred_t = out["translation"].float().cpu().numpy()
        pred_obj = np.vectorize(lambda c: cls_to_objid.get(int(c), -1))(pred_cls)
        for b, fr in enumerate(chunk):
            total_gt += len(fr.objects)
            used = np.zeros(M, bool)
            for obj in fr.objects:
                hit = next((d for d in range(M) if det_valid[b, d] and not used[d]
                            and pred_obj[b, d] == obj.obj_id), None)
                if hit is None:
                    continue
                used[hit] = True
                matched_q.append(pred_q[b, hit])
                matched_t.append(pred_t[b, hit])
                matched_gq.append(_gt_quat(obj.rot_mat))
                matched_gt_t.append(obj.trans_mm / 1000.0)
                matched_ids.append(obj.obj_id)

    n_match = len(matched_ids)
    det_rate = n_match / max(total_gt, 1)
    print(f"split {args.split}: {len(frames_idx)} frames, {total_gt} GT objects "
          f"(max_objects={M})")
    print(f"object detection rate (class-matched): {det_rate * 100:.1f}%")
    if n_match == 0:
        print("ADD-0.1d (full system, unmatched = incorrect): 0.00%")
        return
    CH = max(B * M, 1)
    pad = (-n_match) % CH
    pq = np.concatenate([matched_q, np.zeros((pad, 4))]).astype(np.float32)
    pt = np.concatenate([matched_t, np.zeros((pad, 3))]).astype(np.float32)
    gq = np.concatenate([matched_gq, np.zeros((pad, 4))]).astype(np.float32)
    gt = np.concatenate([matched_gt_t, np.zeros((pad, 3))]).astype(np.float32)
    ids = np.concatenate([matched_ids, -np.ones(pad)]).astype(np.int64)
    pq[n_match:, 3] = 1.0
    gq[n_match:, 3] = 1.0
    sums = {"add": 0.0, "add_s": 0.0, "acc": 0.0, "count": 0}
    for s in range(0, len(ids), CH):
        m = evaluator.eval_metrics(pq[s:s + CH], pt[s:s + CH], gq[s:s + CH], gt[s:s + CH],
                                   ids[s:s + CH])
        c = m["count"]
        sums["add"] += m["add_mean"] * c
        sums["add_s"] += m["add_s_mean"] * c
        sums["acc"] += m["add_01d_acc"] * c
        sums["count"] += c
    n = max(sums["count"], 1)
    acc_matched = sums["acc"] / n
    print(f"ADD (matched): {sums['add'] / n:.1f}mm  ADD-S (matched): {sums['add_s'] / n:.1f}mm  "
          f"ADD-0.1d (matched): {acc_matched:.2f}%")
    print(f"ADD-0.1d (full system, unmatched = incorrect): {acc_matched * det_rate:.2f}%")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", required=True,
                    choices=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--yolo-weights", required=True)
    ap.add_argument("--pose-weights", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val", "test"],
                    help="'train' only for held-out scene trees that trained nothing")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--conf-thresh", type=float, default=0.25)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--rot-head-wide", action="store_true",
                    help="a weights dir trained with the wide rotation head")
    ap.add_argument("--no-fusion-attention", dest="fusion_attention", action="store_false",
                    default=True, help="a weights dir trained without rgbd's attention")
    ap.add_argument("--z-from-backbone", action="store_true",
                    help="an rgb_geometric weights dir with z from the ResNet features")
    ap.add_argument("--z-backbone-wide", action="store_true",
                    help="an rgb_geometric weights dir with the double-width Z-CNN")
    ap.add_argument("--int8-backbone", action="store_true",
                    help="int8 serving: towers and detector quantized on the first batch")
    ap.add_argument("--folded-backbone", action="store_true",
                    help="folded bf16 serving: BatchNorm folded into the towers' convs")
    ap.add_argument("--folded-pallas", action="store_true",
                    help="with --folded-backbone: layer1 as the fused CUDA kernel (img 224)")
    ap.add_argument("--folded-stem", action="store_true",
                    help="with --folded-backbone: the stem as the fused CUDA kernel (img 224)")
    ap.add_argument("--folded-stages", default="",
                    help="with --folded-backbone: comma list of stages 1-4 to run as the "
                         "fused CUDA stage kernel (img 224; stage 1 replaces layer1's)")
    ap.add_argument("--yolo-checkpoint", default="best", choices=["best", "last"],
                    help="which detector checkpoint to deploy")
    ap.add_argument("--checkpoint", default="best", choices=["best", "last", "best_deploy"],
                    help="which Trainer checkpoint to deploy")
    ap.add_argument("--max-objects", type=int, default=1,
                    help=">1 evaluates multi-object frames (every gt.yml annotation)")
    ap.add_argument("--classes", default=None,
                    help="comma list of 1-indexed folder ids in the detector's class order; "
                         "default: the eval root's folders")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.linemod import build_frame_index, build_index
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.losses.add import ADDEvaluator
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.models.yolo.train import load_yolo_variables
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    multi = args.max_objects > 1
    need_depth = args.variant.startswith("rgbd")
    if multi:
        frames_idx = build_frame_index(args.data_root, args.split, require_depth=need_depth)
        if not frames_idx:
            sys.exit("no frames in split")
        samples = [o for fr in frames_idx for o in fr.objects]
    else:
        samples = build_index(args.data_root, args.split, require_depth=need_depth)
        if not samples:
            sys.exit("no samples in split")
    # detection classes: sorted folder index; pose obj_id: folder - 1
    if args.classes:
        folders = [f"{int(x):02d}" for x in args.classes.split(",")]
    else:
        folders = sorted({f"{s.obj_id + 1:02d}" for s in samples})
    cls_to_objid = {i: int(f) - 1 for i, f in enumerate(folders)}

    ycfg = YoloConfig(num_classes=len(folders))
    yolo_state = load_yolo_variables(args.yolo_weights, ycfg, prefer=args.yolo_checkpoint)
    if yolo_state is None:
        sys.exit(f"no detector checkpoint in {args.yolo_weights}")
    flags = dict(rot_head_wide=args.rot_head_wide, fusion_attention=args.fusion_attention,
                 z_from_backbone=args.z_from_backbone, z_backbone_wide=args.z_backbone_wide)
    pose_state = load_model_variables(
        args.pose_weights, get_preset(args.variant, img_size=args.img_size, **flags),
        name=args.checkpoint)
    if pose_state is None:
        sys.exit(f"no pose checkpoint in {args.pose_weights}")
    # --folded-backbone gates the deployed serving configuration: bf16
    compute_dtype = torch.bfloat16 if args.folded_backbone else torch.float32
    pipe = PosePipeline(
        PipelineConfig(variant=args.variant, img_size=args.img_size,
                       conf_thresh=args.conf_thresh, compute_dtype=compute_dtype,
                       max_objects=args.max_objects),
        ycfg, yolo_state, pose_state,
        PoseNetConfig(variant=args.variant, img_size=args.img_size, **flags),
        device=args.device)
    if args.folded_backbone:
        stages = tuple(int(s) for s in args.folded_stages.split(",") if s)
        at_224 = args.img_size == 224
        pipe.fold_backbones(pallas_layer1=args.folded_pallas and at_224 and 1 not in stages,
                            pallas_stem=args.folded_stem and at_224, pallas_stages=stages)
    evaluator = ADDEvaluator(args.mesh_dir, device=args.device)
    if multi:
        _eval_multi(args, frames_idx, pipe, evaluator, cls_to_objid)
        return

    B = args.batch_size
    tot = {"add": 0.0, "add_s": 0.0, "acc": 0.0, "n_batches": 0, "detected": 0,
           "cls_correct": 0, "n": 0}
    calibrated = not args.int8_backbone
    t0 = time.perf_counter()
    for start in range(0, len(samples), B):
        chunk = samples[start:start + B]
        frames, depths = _load_frames([(s.img_path, s.depth_path) for s in chunk], need_depth)
        gt_q, gt_t, gt_ids, K = _gt_arrays(chunk)
        if not calibrated:  # the first batch is the int8 calibration set
            pipe.quantize_backbones(frames, K, depths, include_detector=True)
            calibrated = True
        _score_batch(pipe(frames, K, depths), evaluator, gt_q, gt_t, gt_ids, cls_to_objid, tot)
    secs = time.perf_counter() - t0

    nb = max(tot["n_batches"], 1)
    det_rate = tot["detected"] / max(tot["n"], 1)
    acc_detected = tot["acc"] / nb
    print(f"split {args.split}: {tot['n']} frames")
    print(f"detection rate: {det_rate * 100:.1f}%  class acc (of detected): "
          f"{tot['cls_correct'] / max(tot['detected'], 1) * 100:.1f}%")
    # ADD means over detected frames; the full-system ADD-0.1d counts an
    # undetected frame as incorrect
    print(f"ADD (detected): {tot['add'] / nb:.1f}mm  ADD-S (detected): {tot['add_s'] / nb:.1f}mm  "
          f"ADD-0.1d (detected): {acc_detected:.2f}%")
    print(f"ADD-0.1d (full system, undetected = incorrect): {acc_detected * det_rate:.2f}%")
    print(f"evaluated {tot['n']} frames in {secs:.3f} s after set-up: "
          f"{tot['n'] / secs:.2f} frames/s (host clock)")


if __name__ == "__main__":
    main()
