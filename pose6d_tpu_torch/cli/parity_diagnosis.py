"""The `diagnosis` section of the evidence document: the rgbd fusion arms
and the gradient probe (counterpart of scripts/parity_diagnosis.py).

Reads <workdir>/results.json (parity_run's rgbd arms: rgbd, and its
--rot-head-wide, --no-fusion-attention and --attn-zero-init runs) and
<workdir>/rgbd_gradient_probe.json (cli/probe_rgbd_gradients.py), and
states what they show: an arm that has not run is left out of the table
and named as not run.

  python -m pose6d_tpu_torch.cli.parity_diagnosis --workdir /tmp/p6d
"""

import argparse
import json
import os

from pose6d_tpu_torch.cli import add_device_arg

# (run name, what it changes), the JAX script's table order
ARMS = (("rgbd", "reference architecture"),
        ("rgbd_widehead", "+ wide rotation head"),
        ("rgbd_noattn", "− CrossModalAttention (concat fusion)"),
        ("rgbd_zeroattn", "attention kept, out_proj zero-init (starts at concat)"))


def row(results: dict, name: str):
    """(best val ADD-0.1d, best epoch, epochs run, final train loss) of a
    run, or None when it has not run."""
    r = results.get(name)
    if not r:
        return None
    return (r["best_add01d"], r.get("best_epoch", "?"), r.get("epochs_run", "?"),
            r.get("final_train_loss"))


def table_row(r, note: str) -> str:
    if r is None:
        return ""
    acc, be, er, fl = r
    loss = f"{fl:.3f}" if isinstance(fl, (int, float)) else "—"
    return f"| {note} | {acc:.2f}% (ep {be}) | {er} | {loss} |\n"


def markdown(results: dict, probe: dict, device: str, card: str) -> str:
    rows = {name: row(results, name) for name, _ in ARMS}
    ran = [name for name, r in rows.items() if r is not None]
    missing = [name for name, r in rows.items() if r is None]
    lines = [
        "## The rgbd fusion stall: the port's arms and gradient probe\n\n",
        f"parity_run's rgbd arms on the fixture (device {device}; {card}); a run's name "
        "carries its flags (`--rot-head-wide`, `--no-fusion-attention`, "
        "`--attn-zero-init`):\n\n",
        "| rgbd configuration | best val ADD-0.1d | epochs run | final train loss |\n",
        "|---|---|---|---|\n",
        *(table_row(rows[name], note) for name, note in ARMS),
        "\n",
    ]
    if missing:
        lines.append("Not run on the card: " + ", ".join(f"`{m}`" for m in missing)
                     + "; those rows are absent, and nothing below rests on them.\n\n")
    base = rows["rgbd"]
    for name, note in ARMS[1:]:
        r = rows[name]
        if base is not None and r is not None:
            lines.append(f"- {note} (`{name}`): best {r[0]:.2f}% against the reference "
                         f"architecture's {base[0]:.2f}%"
                         + (f", final train loss {r[3]:.3f} against {base[3]:.3f}"
                            if isinstance(r[3], (int, float)) and isinstance(base[3], (int, float))
                            else "") + ".\n")
    if probe:
        init = {k: v["grad_rms"]["init"] for k, v in probe.items()}
        lines.append(
            "- Gradient probe (`rgbd_gradient_probe.json`, `python -m "
            "pose6d_tpu_torch.cli.probe_rgbd_gradients`: the rotation-only loss, plain AdamW "
            "5e-4): RMS gradient of the rgb backbone at the first step "
            + ", ".join(f"{k} {v.get('rgb_backbone', float('nan')):.2e}" for k, v in init.items())
            + "; loss over the probe's steps "
            + ", ".join(f"{k} {v['loss_first']:.4f} -> {v['loss_last']:.4f}"
                        for k, v in probe.items()) + ".\n")
    else:
        lines.append("- The gradient probe has not run (no `rgbd_gradient_probe.json`).\n")
    if base is not None and ran:
        best = max(ran, key=lambda n: rows[n][0])
        lines.append(f"\nOf the arms that ran, `{best}` reaches the highest val ADD-0.1d "
                     f"({rows[best][0]:.2f}%).\n")
    return "".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    with open(os.path.join(args.workdir, "results.json")) as f:
        results = json.load(f)
    probe_path = os.path.join(args.workdir, "rgbd_gradient_probe.json")
    probe = {}
    if os.path.exists(probe_path):
        with open(probe_path) as f:
            probe = json.load(f)
    path = write_section(args.workdir, "diagnosis",
                         markdown(results, probe, args.device, card_of(args.workdir)))
    print(f"wrote {path} and reassembled PARITY_RESULTS.md")


if __name__ == "__main__":
    main()
