"""Section files of the port's evidence document (counterpart of
scripts/parity_md.py).

Every producer owns ONE section file under <workdir>/sections/, and
<workdir>/PARITY_RESULTS.md is regenerated from whichever sections exist
each time one is written, so re-running any producer refreshes its section
without touching the others:

  base         cli/parity_run.py         the trained runs' table
  attribution  cli/probe_components.py   rotation / xy / z errors, per object
  e2e          cli/parity_e2e.py         the detector in the loop
  multiobj     cli/multiobj_md.py        multi-object frames
  selection    cli/selection_study.py    best vs best_deploy vs last
  serving      cli/serving_md.py         float / int8 / folded gates
  narrative    cli/parity_report.py      what the tables show
  ablation     (written by hand)
  diagnosis    cli/parity_diagnosis.py   the rgbd fusion arms and the probe
  symmetric    cli/parity_symmetric.py   ADD-S on folders 10 and 11

The document is always <workdir>/PARITY_RESULTS.md: nothing here writes
outside the workdir.
"""

import os

# assembly order; each entry is (section file stem, required header to pin)
SECTIONS = [
    ("base", "# Accuracy-parity evidence"),
    ("attribution", "## Component attribution"),
    ("e2e", "## Full-system (detector-in-the-loop) evaluation"),
    ("multiobj", "### Multi-object frames"),
    ("selection", "## Checkpoint-selection study"),
    ("serving", "## Serving-mode accuracy gates"),
    ("narrative", "## Reading the tables"),
    ("ablation", "## Ablation:"),
    ("diagnosis", "## The rgbd fusion stall"),
    ("symmetric", "## Symmetric objects"),
]


def section_dir(workdir: str) -> str:
    return os.path.join(workdir, "sections")


def write_section(workdir: str, name: str, text: str) -> str:
    """Write one section file and reassemble the document."""
    assert name in {n for n, _ in SECTIONS}, name
    d = section_dir(workdir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.md")
    with open(path, "w") as f:
        f.write(text if text.endswith("\n") else text + "\n")
    assemble(workdir)
    return path


def assemble(workdir: str) -> str:
    """Concatenate the existing section files, in SECTIONS' order, into
    <workdir>/PARITY_RESULTS.md; returns its path."""
    out_path = os.path.join(workdir, "PARITY_RESULTS.md")
    parts = []
    for name, _ in SECTIONS:
        p = os.path.join(section_dir(workdir), f"{name}.md")
        if os.path.exists(p):
            with open(p) as f:
                parts.append(f.read().rstrip() + "\n")
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path


def card_of(workdir: str) -> str:
    """The card the workdir's runs used: the first line of
    <workdir>/device.txt (parity_torch/run_evidence.sh writes nvidia-smi's
    name and power limit there), else "card not recorded"."""
    path = os.path.join(workdir, "device.txt")
    if os.path.exists(path):
        with open(path) as f:
            line = f.readline().strip()
        if line:
            return line
    return "card not recorded"
