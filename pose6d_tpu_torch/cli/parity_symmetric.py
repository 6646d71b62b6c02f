"""The `symmetric` section of the evidence document (counterpart of
scripts/parity_symmetric.py): ADD-S deciding accuracy for a trained system.

The base fixture's objects are all asymmetric, so ADD-S for symmetric
objects (losses/add.py: SYMMETRIC_OBJECT_IDS = (9, 10), LineMOD's eggbox
and glue, score by closest-point distance) shows only in unit tests there.
This reads a parity_run trained on a fixture with folders 10 and 11 drawn
180-degree-symmetric:

  python -m pose6d_tpu_torch.cli.parity_run --workdir /tmp/p6d/sym \\
      --variants rgbd_geometric --rot-head-wide --symmetric-objects
  python -m pose6d_tpu_torch.cli.parity_symmetric --workdir /tmp/p6d \\
      --sym-workdir /tmp/p6d/sym

and writes the section from the run's results.json and a per-object
breakdown of its checkpoint (--checkpoint, `best` by default) on the val
split: the host loader at --batch-size (32) with the last partial batch
dropped, as the JAX script reads it, and add_per_sample, whose ADD-S
search is the addmin kernel on the card. --sym-workdir defaults to
<workdir>/sym.
"""

import argparse
import json
import os

from pose6d_tpu_torch.cli import add_device_arg


def restore(model, save_dir: str, checkpoint: str) -> None:
    """Load `checkpoint` ({best,best_deploy,last}.pt) of save_dir into
    model; a missing or unreadable file exits, it does not fall back."""
    from pose6d_tpu_torch.train.checkpoint import CheckpointManager

    payload = CheckpointManager(save_dir).load(model, checkpoint)
    if payload is None:
        raise SystemExit(f"no readable {checkpoint} checkpoint in {save_dir}")
    model.load_state_dict(payload["model"], strict=True)


def object_rows(per_object: dict, symmetric_ids) -> dict:
    """{obj_id: {"add": [...], "add_s": [...], "cor": [...]}} (metres and
    0/1 per sample) -> the breakdown's rows: {obj_id: {"symmetric",
    "add_mm", "add_s_mm", "add01d_pct"}}, in obj_id order."""
    import numpy as np

    sym = set(int(i) for i in symmetric_ids)
    return {oid: {"symmetric": oid in sym,
                  "add_mm": 1000 * float(np.mean(d["add"])),
                  "add_s_mm": 1000 * float(np.mean(d["add_s"])),
                  "add01d_pct": 100 * float(np.mean(d["cor"]))}
            for oid, d in sorted(per_object.items())}


def accumulate(acc: dict, per: dict, obj_ids) -> None:
    """Add a batch's add_per_sample output (tensors [B]) to acc by object
    id (numpy [B])."""
    import numpy as np

    add, add_s, cor = (per[k].cpu().numpy() for k in ("add", "add_s", "correct"))
    for oid in np.unique(obj_ids):
        sel = obj_ids == oid
        d = acc.setdefault(int(oid), {"add": [], "add_s": [], "cor": []})
        d["add"].extend(add[sel].tolist())
        d["add_s"].extend(add_s[sel].tolist())
        d["cor"].extend(cor[sel].tolist())


def per_object_breakdown(sym_workdir: str, variant: str = "rgbd_geometric",
                         batch_size: int = 32, checkpoint: str = "best", img_size: int = 224,
                         num_workers: int = 4, device="cuda") -> dict:
    """Per-object plain ADD vs ADD-S of weights_<variant>_widehead's
    `checkpoint` on the symmetric fixture's val split: for the twin-pose
    objects (ids 9 and 10) ADD-S is the closest-point distance that the
    0.1d threshold uses."""
    import numpy as np
    import torch

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.geometry.quat import quat_normalize, quat_to_mat
    from pose6d_tpu_torch.losses.add import ADDEvaluator, add_per_sample
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.ops.augment import AugmentConfig, eval_preprocess
    from pose6d_tpu_torch.train.loop import decompress_batch, model_inputs, pose_config, to_device

    cfg = get_preset(variant, rot_head_wide=True, img_size=img_size,
                     augment=AugmentConfig(grayscale_p=0.0))
    model = PoseNet(pose_config(cfg))
    restore(model, os.path.join(sym_workdir, f"weights_{variant}_widehead"), checkpoint)
    model.to(device).eval()

    loader = LineMODPoseLoader(
        os.path.join(sym_workdir, "synth", "data"), mode="val", flavor="rgbd",
        img_size=cfg.img_size, augment_bbox=False, num_workers=num_workers,
        compact_arrays=True)
    ev = ADDEvaluator(os.path.join(sym_workdir, "synth", "models"), device=device)
    acc: dict = {}
    try:
        with torch.no_grad():
            for host in loader.batches(batch_size, np.random.default_rng(0), shuffle=False,
                                       drop_remainder=True):
                batch = decompress_batch(to_device(host, device))
                pred_rot, pred_trans = model(**model_inputs(cfg.variant, batch,
                                                            eval_preprocess(batch["rgb"])))
                per = add_per_sample(
                    ev.points, ev.diameters, ev.symmetric, ev.present, quat_to_mat(pred_rot),
                    pred_trans, quat_to_mat(quat_normalize(batch["quat"])), batch["trans"],
                    batch["obj_id"], num_valid=ev.num_valid)
                accumulate(acc, per, np.asarray(host["obj_id"]))
    finally:
        loader.close()
    if not acc:
        raise SystemExit(f"no full batch of {batch_size} in the val split of {sym_workdir}")
    return object_rows(acc, np.nonzero(ev.symmetric.cpu().numpy())[0])


def markdown(results: dict, per_obj: dict, sym_workdir: str, checkpoint: str, device: str,
             card: str) -> str:
    """The section: the run table and the per-object table."""
    nan = float("nan")
    rows = "".join(
        f"| {name} | {r['best_add01d']:.2f}% (ep {r.get('best_epoch', '?')}) "
        f"| {r.get('epochs_run', '?')} | {r.get('val_add_mm_at_best', nan):.1f} "
        f"| {r.get('val_add_s_mm_at_best', nan):.1f} |\n"
        for name, r in sorted(results.items()))
    obj_rows = "".join(
        f"| obj {oid + 1:02d}{' **(symmetric)**' if o['symmetric'] else ''} "
        f"| {o['add_mm']:.1f} | {o['add_s_mm']:.1f} | {o['add01d_pct']:.1f}% |\n"
        for oid, o in per_obj.items())
    sym = [o for o in per_obj.values() if o["symmetric"]]
    sym_acc = ", ".join(f"obj {oid + 1:02d} {o['add01d_pct']:.1f}%"
                        for oid, o in per_obj.items() if o["symmetric"])
    below = all(o["add_s_mm"] <= o["add_mm"] + 1e-3 for o in per_obj.values())
    return f"""## Symmetric objects: the ADD-S decision path under a trained system, pose6d_tpu_torch

The fixture of `{sym_workdir}` holds folders 10 and 11 (object ids 9 and
10, LineMOD's eggbox and glue) drawn with 180-degree-symmetric markers
(`parity_run --symmetric-objects`), so every pose has an
indistinguishable twin; rgbd_geometric with the wide rotation head is
trained on it (device {device}; {card}).

| run | best val ADD-0.1d | epochs | ADD mm | ADD-S mm |
|---|---|---|---|---|
{rows}
Per object, checkpoint `{checkpoint}`, val split (`python -m
pose6d_tpu_torch.cli.parity_symmetric`; ADD-0.1d takes ADD-S for the
symmetric ids and plain ADD otherwise; ADD-S's nearest-point search is
the addmin kernel on a CUDA device):

| object | ADD mm | ADD-S mm | ADD-0.1d |
|---|---|---|---|
{obj_rows}
Symmetric objects in the table: {len(sym)} ({sym_acc or "none"}). ADD-S
{"is at most ADD on every row" if below else "exceeds ADD on some row"}
(the closest-point distance is a lower bound of the point-to-point one).
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity",
                    help="the evidence document's workdir (sections/, PARITY_RESULTS.md)")
    ap.add_argument("--sym-workdir", default=None,
                    help="the symmetric run's parity_run workdir (default <workdir>/sym)")
    ap.add_argument("--checkpoint", default="best", choices=["best", "best_deploy", "last"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--num-workers", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    sym_workdir = args.sym_workdir or os.path.join(args.workdir, "sym")

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    with open(os.path.join(sym_workdir, "results.json")) as f:
        results = json.load(f)
    per_obj = per_object_breakdown(sym_workdir, batch_size=args.batch_size,
                                   checkpoint=args.checkpoint, img_size=args.img_size,
                                   num_workers=args.num_workers, device=args.device)
    for oid, o in per_obj.items():
        print(f"obj {oid + 1:02d}{' (symmetric)' if o['symmetric'] else ''}: ADD "
              f"{o['add_mm']:.1f} mm, ADD-S {o['add_s_mm']:.1f} mm, ADD-0.1d "
              f"{o['add01d_pct']:.1f}%")
    with open(os.path.join(sym_workdir, "symmetric_breakdown.json"), "w") as f:
        json.dump({"checkpoint": args.checkpoint, "per_object": per_obj}, f, indent=2)
    path = write_section(args.workdir, "symmetric",
                         markdown(results, per_obj, sym_workdir, args.checkpoint, args.device,
                                  card_of(args.workdir)))
    print(f"wrote {path} and reassembled PARITY_RESULTS.md")


if __name__ == "__main__":
    main()
