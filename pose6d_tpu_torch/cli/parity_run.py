"""Accuracy-parity evidence: train pose variants to saturation on the
synthetic fixture (counterpart of scripts/parity_run.py).

No real LineMOD is at hand, so the claim is made on the fixture of
data/synthetic.py: each variant must drive val ADD-0.1d far above chance
under the reference recipe (configs/presets.py) with the script's
deviations below, and the metrics.csv curves are the evidence.

  python -m pose6d_tpu_torch.cli.parity_run --workdir /tmp/pose6d_torch_parity \\
      --variants rgbd_geometric --rot-head-wide

Deviations from the reference recipe (which assumes ImageNet-pretrained
towers and real data), as the JAX script makes them:
  - lr 5e-4 and plateau patience 15: val ADD-0.1d sits at 0 early, and
    patience 5 halves the rate to nothing before the from-scratch rotation
    pathway converges;
  - 700 frames an object: SO(3) regression from scratch needs denser
    rotation coverage than 300 views;
  - RandomGrayscale off: the fixture encodes orientation in marker colours;
  - rotations in a 75-degree ball: uniform SO(3) puts the quaternion
    double-cover seam inside the data, which no continuous regressor
    crosses.

The fixture is generated once under <workdir>/synth (objects 1..N, and
with --symmetric-objects folders 10 and 11); each variant trains into
<workdir>/weights_<name>/ (resumable: {last,best,best_deploy}.pt and
metrics.csv), and results.json and PARITY.md (the table, also the
`base` section of <workdir>/PARITY_RESULTS.md, cli/parity_md.py) are
rewritten after each. The run name carries the flags' suffixes (_widehead, _noattn,
_zeroattn, _zbb, _zwide, _bf16, _warmstart). The train split is resident
on the card (the gather kernel) unless --no-device-preprocess; validation
reads through the host loader (the addmin kernel).
"""

import argparse
import csv
import json
import os

from pose6d_tpu_torch.cli import add_device_arg

# parity_run's run-name suffixes, in the order they are appended
SUFFIXES = ("_widehead", "_noattn", "_zeroattn", "_zbb", "_zwide", "_bf16", "_warmstart")


def summarize_variant(save_dir: str, best: float) -> dict:
    """A variant's metrics.csv condensed into its results entry: the best
    ADD-0.1d, first and best epochs, and the final ADD / loss values."""
    rows = []
    with open(os.path.join(save_dir, "metrics.csv")) as f:
        for row in csv.DictReader(f):
            rows.append({k: float(v) for k, v in row.items()})
    # a resume after a cut run logs its restart window again: keep the last
    # row of each epoch, the one behind the checkpoints
    rows = list({int(r["epoch"]): r for r in rows}.values())
    rows.sort(key=lambda r: r["epoch"])
    best_row = max(rows, key=lambda r: r["val_acc"])
    first_hit = next((r for r in rows if r["val_acc"] >= 0.5 * best), None)
    return {
        "best_add01d": best,
        # metrics.csv's epochs are 0-based; the log's "Epoch N" is 1-based
        "best_epoch": int(best_row["epoch"]) + 1,
        "epochs_run": len(rows),
        "val_add_mm_at_best": best_row["val_add"],
        "val_add_s_mm_at_best": best_row["val_add_s"],
        "final_train_loss": rows[-1]["train_loss"],
        "epoch_half_best": int(first_hit["epoch"]) + 1 if first_hit else None,
    }


def run_name(variant: str, args) -> str:
    """variant with the suffixes of the flags given."""
    flags = (args.rot_head_wide, not args.fusion_attention, args.attn_zero_init,
             args.z_from_backbone, args.z_backbone_wide, args.bf16, bool(args.init_towers_from))
    return variant + "".join(s for s, on in zip(SUFFIXES, flags) if on)


def flags_of(name: str) -> dict:
    """The TrainConfig flags a run name's suffixes stand for, and its base
    variant: {"variant", "rot_head_wide", ...}."""
    base = name
    for suf in SUFFIXES:
        base = base.replace(suf, "")
    return {"variant": base, "rot_head_wide": "_widehead" in name,
            "fusion_attention": "_noattn" not in name, "attn_zero_init": "_zeroattn" in name,
            "z_from_backbone": "_zbb" in name, "z_backbone_wide": "_zwide" in name,
            "compute_dtype": "bfloat16" if "_bf16" in name else "float32"}


def write_markdown(args, results: dict) -> str:
    """The results table, as the JAX script's base table of
    PARITY_RESULTS.md: <workdir>/PARITY.md and the `base` section.
    Returns PARITY.md's path."""
    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    lines = [
        "# Accuracy-parity evidence (synthetic fixture), pose6d_tpu_torch\n\n",
        f"Trained by `python -m pose6d_tpu_torch.cli.parity_run` ({args.objects} objects x "
        f"{args.frames} frames, rotations in a {args.max_angle_deg:.0f}-degree geodesic ball, "
        f"lr {args.lr}, plateau patience {args.patience}, batch {args.batch_size}, early stop "
        f"at {args.early_stop_acc}% val ADD-0.1d, seed {args.seed}, device {args.device}; "
        f"{card_of(args.workdir)}). Per-epoch curves: `weights_<variant>/metrics.csv`.\n\n",
        "| variant | best val ADD-0.1d % | best epoch | epochs run | "
        "ADD mm @ best | ADD-S mm @ best | final train loss |\n",
        "|---|---|---|---|---|---|---|\n",
    ]
    for v, r in results.items():
        lines.append(f"| {v} | {r['best_add01d']:.2f} | {r['best_epoch']} | {r['epochs_run']} "
                     f"| {r['val_add_mm_at_best']:.1f} | {r['val_add_s_mm_at_best']:.1f} "
                     f"| {r['final_train_loss']:.4f} |\n")
    path = os.path.join(args.workdir, "PARITY.md")
    with open(path, "w") as f:
        f.writelines(lines)
    write_section(args.workdir, "base", "".join(lines))
    return path


def warm_start(trainer, args, variant: str) -> None:
    """Graft the towers of the donor run in --init-towers-from into the
    trainer's fresh init (train/warmstart.py), unless the trainer's
    save_dir already holds a checkpoint: fit() resumes that one, whose run
    was warm-started when it began."""
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.train.checkpoint import BEST_NAME, load_model_variables
    from pose6d_tpu_torch.train.warmstart import graft_towers

    if trainer.ckpt.has_checkpoint() or trainer.ckpt.has_checkpoint(BEST_NAME):
        print(f"[parity] {trainer.ckpt.save_dir} already has a checkpoint; resuming it, "
              "the tower graft skipped (made when that run began)")
        return
    donor_flags = flags_of(args.donor_variant or variant)
    donor_cfg = get_preset(donor_flags.pop("variant"), batch_size=args.batch_size,
                           **donor_flags)
    donor = load_model_variables(args.init_towers_from, donor_cfg)
    if donor is None:
        raise SystemExit(f"--init-towers-from: no checkpoint in {args.init_towers_from}")
    model = trainer.state.model
    grafted_sd, grafted = graft_towers(model.state_dict(), donor)
    model.load_state_dict(grafted_sd, strict=True)
    print(f"[parity] warm-started towers: {grafted} from {args.init_towers_from}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--frames", type=int, default=700)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--early-stop-acc", type=float, default=97.0)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--max-angle-deg", type=float, default=75.0)
    ap.add_argument("--variants", nargs="+",
                    default=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rot-head-wide", action="store_true",
                    help="the rgb-style 2048/1024/512 rotation head for the geometric variants")
    ap.add_argument("--symmetric-objects", action="store_true",
                    help="add folders 10 and 11 with 180-degree-symmetric markers (ADD-S); "
                         "use a fresh --workdir")
    ap.add_argument("--no-fusion-attention", dest="fusion_attention", action="store_false",
                    default=True, help="rgbd: concat fusion without CrossModalAttention")
    ap.add_argument("--attn-zero-init", action="store_true",
                    help="rgbd: attention on, its out_proj zero at init")
    ap.add_argument("--z-from-backbone", action="store_true",
                    help="rgb_geometric: the z head on the ResNet50 features")
    ap.add_argument("--z-backbone-wide", action="store_true",
                    help="rgb_geometric: a double-width Z-CNN")
    ap.add_argument("--init-towers-from", default=None,
                    help="a trained run's save_dir whose towers are grafted into the fresh "
                         "init (train/warmstart.py)")
    ap.add_argument("--donor-variant", default=None,
                    help="the donor run's name with its suffixes (e.g. rgbd_noattn); the "
                         "trained variant by default")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 towers in training (validation f32)")
    ap.add_argument("--no-device-preprocess", dest="device_preprocess", action="store_false",
                    default=True, help="train from the host loader, not the resident split")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod
    from pose6d_tpu_torch.ops.augment import AugmentConfig
    from pose6d_tpu_torch.train.trainer import Trainer

    os.makedirs(args.workdir, exist_ok=True)
    data_root = os.path.join(args.workdir, "synth", "data")
    mesh_dir = os.path.join(args.workdir, "synth", "models")
    # folders 1..N, and with --symmetric-objects 10 and 11 (LineMOD's
    # eggbox and glue); a folder already there is kept
    want = list(range(1, args.objects + 1)) + ([10, 11] if args.symmetric_objects else [])
    missing = [o for o in want if not os.path.isdir(os.path.join(data_root, f"{o:02d}"))]
    if missing:
        print(f"[parity] generating synthetic objects {missing} x {args.frames} frames",
              flush=True)
        generate_synthetic_linemod(os.path.join(args.workdir, "synth"), obj_ids=tuple(missing),
                                   frames_per_obj=args.frames, seed=args.seed,
                                   max_angle_deg=args.max_angle_deg, symmetric_obj_ids=(10, 11))

    results_path = os.path.join(args.workdir, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for variant in args.variants:
        name = run_name(variant, args)
        save_dir = os.path.join(args.workdir, f"weights_{name}")
        flags = flags_of(name)
        del flags["variant"]
        cfg = get_preset(variant, epochs=args.epochs, batch_size=args.batch_size,
                         img_size=args.img_size, learning_rate=args.lr,
                         plateau_patience=args.patience,
                         augment=AugmentConfig(grayscale_p=0.0), **flags)
        print(f"\n=== {name}: training to {args.epochs} epochs "
              f"(early stop at {args.early_stop_acc}% ADD-0.1d) ===", flush=True)
        trainer = Trainer(cfg, data_root, mesh_dir, save_dir, seed=args.seed,
                          num_workers=args.num_workers,
                          cache_decoded=True,  # ~4 GB at 4,200 frames; decoding leads host time
                          device_preprocess=args.device_preprocess, device=args.device)
        try:
            if args.init_towers_from:
                warm_start(trainer, args, variant)
            best = trainer.fit(epochs=args.epochs, early_stop_acc=args.early_stop_acc)
        finally:
            trainer.close()
        results[name] = summarize_variant(save_dir, best)
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
        write_markdown(args, results)

    print("\n=== summary (val ADD-0.1d %, synthetic fixture) ===")
    for name, r in results.items():
        print(f"  {name:<26} {r['best_add01d']:.2f}")
    print(f"\nresults.json, PARITY.md and each run's metrics.csv under {args.workdir}")
    print("The table again: python -m pose6d_tpu_torch.cli.compare "
          f"--data-root {data_root} --mesh-dir {mesh_dir} --weights-root {args.workdir}")


if __name__ == "__main__":
    main()
