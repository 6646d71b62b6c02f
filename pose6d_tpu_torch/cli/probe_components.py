"""Per-component error of trained parity runs (counterpart of
scripts/probe_components.py): each run's val error split into rotation
(geodesic, degrees) and translation (|xy| and |z|, mm), and its ADD(-S) /
ADD-0.1d per object. This attributes the ADD-0.1d of cli/parity_run.py's
table: rgb regresses x/y from a recentred crop that carries no crop
location, so its xy error is bound by the architecture (the reference's
PoseNetRGB trails every variant on real LineMOD too), while the geometric
and depth variants recover xy (and z) by pinhole and depth.

  python -m pose6d_tpu_torch.cli.probe_components --workdir /tmp/pose6d_torch_parity \\
      --variants rgbd_geometric rgbd_geometric_widehead

A run name carries parity_run's suffixes (weights_<name>/); its flags
build the architecture it was trained with. The checkpoint is read with
train/checkpoint.CheckpointManager; a .pt is replaced by rename, so a read
during training sees the previous file or the next one whole. Writes
probe_results.json and PROBE.md (the two tables; also the `attribution`
section of <workdir>/PARITY_RESULTS.md, cli/parity_md.py) in --workdir.
"""

import argparse
import json
import os

from pose6d_tpu_torch.cli import add_device_arg

VARIANTS = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]


def probe_variant(name: str, workdir: str, ckpt: str, batches: int, batch_size: int,
                  num_workers: int, img_size: int, device) -> dict:
    """The val split's component errors and per-object ADD of run `name`."""
    import numpy as np
    import torch

    from pose6d_tpu_torch.cli.parity_run import flags_of
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.geometry.quat import quat_normalize, quat_to_mat
    from pose6d_tpu_torch.losses.add import ADDEvaluator, add_per_sample
    from pose6d_tpu_torch.losses.pose_loss import geodesic_distance
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train.checkpoint import CheckpointManager
    from pose6d_tpu_torch.train.loop import decompress_batch, model_inputs, pose_config, to_device

    flags = flags_of(name)
    variant = flags.pop("variant")
    cfg = get_preset(variant, img_size=img_size, **flags)
    model = PoseNet(pose_config(cfg))
    payload = CheckpointManager(os.path.join(workdir, f"weights_{name}")).load(model, ckpt)
    if payload is None:
        raise SystemExit(f"could not restore {ckpt} of {name}")
    model.load_state_dict(payload["model"], strict=True)
    model.to(device).eval()

    loader = LineMODPoseLoader(os.path.join(workdir, "synth", "data"), mode="val",
                               flavor="rgbd" if variant.startswith("rgbd") else "rgb",
                               img_size=cfg.img_size, augment_bbox=False,
                               num_workers=num_workers, compact_arrays=True)
    ev = ADDEvaluator(os.path.join(workdir, "synth", "models"), device=device)
    geos, xy, z = [], [], []
    obj_eff: dict = {}
    obj_cor: dict = {}
    try:
        with torch.no_grad():
            for i, host in enumerate(loader.batches(batch_size, np.random.default_rng(0),
                                                    shuffle=False, drop_remainder=True)):
                batch = decompress_batch(to_device(host, device))
                pred_rot, pred_trans = model(**model_inputs(variant, batch,
                                                            eval_preprocess(batch["rgb"])))
                gt_q = quat_normalize(batch["quat"])
                geos.append(float(geodesic_distance(pred_rot, gt_q)))
                dt = (pred_trans - batch["trans"]).cpu().numpy()
                # the planar error ||(dx, dy)||, as the |xy| column says
                xy.append(float(np.linalg.norm(dt[:, :2], axis=1).mean()))
                z.append(float(np.abs(dt[:, 2]).mean()))
                per = add_per_sample(ev.points, ev.diameters, ev.symmetric, ev.present,
                                     quat_to_mat(pred_rot), pred_trans, quat_to_mat(gt_q),
                                     batch["trans"], batch["obj_id"], num_valid=ev.num_valid)
                eff, cor = per["effective"].cpu().numpy(), per["correct"].cpu().numpy()
                for oid in np.unique(host["obj_id"]):
                    sel = host["obj_id"] == oid
                    obj_eff.setdefault(int(oid), []).extend(eff[sel].tolist())
                    obj_cor.setdefault(int(oid), []).extend(cor[sel].tolist())
                if batches and i + 1 >= batches:
                    break
    finally:
        loader.close()
    diam_mm = 1000 * ev.diameters.cpu().numpy()
    return {
        "variant": name,
        "ckpt": ckpt,
        "val_geodesic_deg": float(np.degrees(np.mean(geos))),
        "val_xy_err_mm": 1000 * float(np.mean(xy)),
        "val_z_err_mm": 1000 * float(np.mean(z)),
        "per_object": {oid: {"diameter_mm": float(diam_mm[oid]),
                             "add_mm": 1000 * float(np.mean(obj_eff[oid])),
                             "add01d_pct": 100 * float(np.mean(obj_cor[oid]))}
                       for oid in sorted(obj_eff)},
    }


MD_HEADER = """## Component attribution (val split), pose6d_tpu_torch

Rotation is the learned pathway in every variant; translation is regressed
(rgb, rgbd), pinhole-derived from a Z net (rgb_geometric) or depth-derived
(rgbd_geometric).

| variant | val geodesic (deg) | val &#124;xy&#124; err (mm) | val &#124;z&#124; err (mm) |
|---|---|---|---|
"""


def markdown(rows: list) -> str:
    """The component table and the per-object table of PARITY_RESULTS.md's
    attribution section."""
    parts = [MD_HEADER]
    for r in rows:
        parts.append(f"| {r['variant']} | {r['val_geodesic_deg']:.2f} "
                     f"| {r['val_xy_err_mm']:.1f} | {r['val_z_err_mm']:.1f} |\n")
    objs = rows[0]["per_object"]
    parts.append("\nPer-object ADD(-S) / ADD-0.1d (val split; the 0.1d threshold scales with "
                 "each object's diameter):\n\n| variant | "
                 + " | ".join(f"obj {oid + 1:02d} (d={o['diameter_mm']:.0f}mm)"
                              for oid, o in objs.items()) + " |\n"
                 + "|---" * (len(objs) + 1) + "|\n")
    for r in rows:
        parts.append(f"| {r['variant']} | " + " | ".join(
            f"{o['add_mm']:.0f}mm / {o['add01d_pct']:.0f}%" for o in r["per_object"].values())
            + " |\n")
    return "".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--variants", nargs="+", default=VARIANTS,
                    help="run names (parity_run's, with their suffixes)")
    ap.add_argument("--ckpt", default="best", choices=["best", "last"])
    ap.add_argument("--batches", type=int, default=0, help="0 = the whole val split")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--num-workers", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rows = []
    for name in args.variants:
        if not os.path.isfile(os.path.join(args.workdir, f"weights_{name}", f"{args.ckpt}.pt")):
            print(f"[probe] {name}: no {args.ckpt} checkpoint yet, skipping")
            continue
        r = probe_variant(name, args.workdir, args.ckpt, args.batches, args.batch_size,
                          args.num_workers, args.img_size, args.device)
        rows.append(r)
        print(f"{name:<26} geodesic {r['val_geodesic_deg']:6.2f} deg | "
              f"xy {r['val_xy_err_mm']:6.1f} mm | z {r['val_z_err_mm']:6.1f} mm")
        for oid, o in r["per_object"].items():
            print(f"    obj {oid + 1:02d} (d={o['diameter_mm']:.0f}mm): "
                  f"ADD(-S) {o['add_mm']:6.1f} mm | ADD-0.1d {o['add01d_pct']:5.1f}%")
    if rows:
        with open(os.path.join(args.workdir, "probe_results.json"), "w") as f:
            json.dump(rows, f, indent=2)
        from pose6d_tpu_torch.cli.parity_md import write_section

        path = os.path.join(args.workdir, "PROBE.md")
        text = markdown(rows)
        with open(path, "w") as f:
            f.write(text)
        write_section(args.workdir, "attribution", text)
        print(f"wrote probe_results.json and {path}")


if __name__ == "__main__":
    main()
