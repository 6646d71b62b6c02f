"""The port is complete: every public top-level function and class of the
JAX package (`pose6d_tpu/**/*.py`) has a counterpart of the same name in
the same module of `pose6d_tpu_torch/`, or an entry in one of the tables
below; every function that reaches `pl.pallas_call` has its hand-written
kernel's wrapper; every `scripts/*.py` and `scripts/*.sh` has a CLI, a
tool or a flag of the port, or a reason. Both packages are read with ast:
neither is imported.

To add an entry: a counterpart under another name or in another module
goes into RENAMES, a Pallas function into PALLAS, a name that has no torch
counterpart into NOT_PORTED with its reason (the one in ROADMAP.md §C), a
script that is not a `pose6d_tpu_torch/cli/` module of its own name into
SCRIPTS. test_tables_name_what_exists fails on an entry whose either side
no longer exists."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "pose6d_tpu", "pose6d_tpu_torch"

# JAX module -> the port's module, where the file has another name: the
# Pallas files, ported with their kernels as CUDA C++ behind these wrappers
MODULES = {"ops/pallas_block.py": "ops/fused_block.py",
           "ops/pallas_addmin.py": "ops/addmin.py"}

# (JAX module, name) -> (port module, name): the same function under
# another name or in another module
RENAMES = {
    ("data/_native.py", "get_lib"): ("data/_native.py", "lib"),
    ("models/convert.py", "torchvision_resnet50_to_flax"):
        ("models/convert.py", "resnet50_from_torchvision"),
    ("models/convert_posenet.py", "posenet_torch_to_flax"):
        ("models/convert_posenet.py", "posenet_from_reference"),
    ("models/convert_posenet.py", "posenet_flax_to_torch"):
        ("models/convert_posenet.py", "posenet_to_reference"),
    ("models/resnet.py", "ResNet"): ("models/resnet.py", "ResNet50"),
    ("models/yolo/convert.py", "ultralytics_yolov8_to_flax"):
        ("models/yolo/convert.py", "yolo_from_ultralytics"),
    ("models/yolo/convert.py", "flax_to_ultralytics_keys"):
        ("models/yolo/convert.py", "yolo_to_ultralytics"),
    ("models/yolo/loss.py", "optax_sigmoid_bce"): ("models/yolo/loss.py", "sigmoid_bce"),
    ("models/yolo/train.py", "hsv_augment"): ("models/yolo/train.py", "hsv_apply"),
    ("models/yolo/train.py", "flip_augment"): ("models/yolo/train.py", "flip_apply"),
    ("models/yolo/train.py", "affine_augment"): ("models/yolo/train.py", "affine_apply"),
    ("models/yolo/train.py", "ema_update"): ("models/yolo/train.py", "ema_update_"),
    ("ops/pallas_block.py", "space_to_depth_2x2"): ("models/resnet.py", "space_to_depth_2x2"),
}

# every function of the JAX package that reaches pl.pallas_call -> the
# wrapper of its hand-written Hopper kernel
PALLAS = {
    ("ops/pallas_block.py", "fused_stem"): ("ops/fused_block.py", "fused_stem"),
    ("ops/pallas_block.py", "fused_layer1"): ("ops/fused_block.py", "fused_layer1"),
    ("ops/pallas_block.py", "fused_stage"): ("ops/fused_block.py", "fused_stage"),
    ("ops/pallas_addmin.py", "pairwise_min_dist_pallas"):
        ("ops/addmin.py", "pairwise_min_dist_kernel"),
    ("ops/gather_frames.py", "_gather_rows_u32"): ("ops/gather_frames.py", "gather_rows_u32"),
}

_SHARDING = ("returns a JAX NamedSharding, which has no torch counterpart; the port "
             "places batches with parallel.shard_batch")
NOT_PORTED = {
    ("parallel/mesh.py", "batch_sharding"): _SHARDING,
    ("parallel/mesh.py", "replicated"): _SHARDING,
}

PENDING_BENCHMARK = "pending: ROADMAP A1, the benchmark PR"
_QUEUE = "not ported: a TPU round's job queue over the JAX scripts"
# scripts/<file> -> (port module, flag or None) where the port runs it as
# a tool or a flag of one, or a reason; any other script is
# pose6d_tpu_torch/cli/<its name>.py
SCRIPTS = {
    "bench_latency.py": PENDING_BENCHMARK,
    "bench_sweep.py": ("ops/profile_pipeline.py", "--sweep"),
    "bench_sweep_rgbd.py": ("ops/profile_pipeline.py", "--sweep"),
    "probe_int8.py": "not ported: asks whether XLA:TPU reaches the int8 MXU; the port's "
                     "conv_s8s32 runs on torch._int_mm, held bit-equal on the card",
    "probe_int8_variants.py": ("ops/profile_pipeline.py", "--int8-variants"),
    "probe_pallas_block.py": "not ported: a Mosaic lowering probe of fused layer1; chip_smoke "
                             "phase 3 and ops/stage_sweep.py cover the port's kernel",
    "profile_gather.py": ("ops/gather_sweep.py", None),
    "profile_int8_stages.py": ("ops/profile_pipeline.py", "--int8-split"),
    "profile_nomodel.py": ("ops/profile_pipeline.py", "--nomodel"),
    "profile_pipeline.py": ("ops/profile_pipeline.py", None),
    "profile_pipeline_prefix.py": ("ops/profile_pipeline.py", "--runs"),
    "profile_rgbd_stages.py": ("ops/profile_pipeline.py", "--runs"),
    "profile_train_stages.py": ("ops/profile_pipeline.py", "--train-split"),
    "profile_train_step.py": ("ops/profile_pipeline.py", "--train-step"),
    "refresh_parity_base.py": ("cli/parity_summarize.py", None),
    "reproduce_reference.sh": ("cli/reproduce.py", None),
    **{f: _QUEUE for f in sorted(os.listdir(os.path.join(ROOT, "scripts")))
       if f.startswith("round") and f.endswith("_queue.sh")},
}


def top_level(path: str, public: bool = True) -> set:
    """The names of a module's top-level functions and classes (only
    those without a leading underscore when `public`)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not (public and n.name.startswith("_"))}


def modules(pkg_root: str) -> list:
    """Every .py file under pkg_root, as paths relative to it."""
    out = []
    for d, _, files in os.walk(pkg_root):
        out += [os.path.relpath(os.path.join(d, f), pkg_root) for f in files
                if f.endswith(".py")]
    return sorted(out)


def has(port_root: str, module: str, name: str) -> bool:
    path = os.path.join(port_root, module)
    return os.path.exists(path) and name in top_level(path, public=False)


def missing(jax_root: str, port_root: str, module: str, tables=None) -> list:
    """The public names of the JAX module `module` that have neither a
    counterpart of the same name in the port's module (MODULES maps the
    path) nor an entry in `tables` (default: RENAMES, PALLAS, NOT_PORTED)."""
    tables = (RENAMES, PALLAS, NOT_PORTED) if tables is None else tables
    target = MODULES.get(module, module)
    return sorted(n for n in top_level(os.path.join(jax_root, module))
                  if not any((module, n) in t for t in tables)
                  and not has(port_root, target, n))


JAX_MODULES = modules(os.path.join(ROOT, JAX_PKG))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_is_ported(module):
    assert not missing(os.path.join(ROOT, JAX_PKG), os.path.join(ROOT, PORT_PKG), module), \
        f"{JAX_PKG}/{module}: no counterpart in {PORT_PKG}/{MODULES.get(module, module)}"


def test_scripts_are_ported():
    """Every scripts/*.py and *.sh: a pose6d_tpu_torch.cli module of its
    name, or SCRIPTS' tool (with its flag in the tool's source), reason or
    pending mark."""
    scripts = sorted(f for f in os.listdir(os.path.join(ROOT, "scripts"))
                     if f.endswith((".py", ".sh")))
    unported = []
    for s in scripts:
        entry = SCRIPTS.get(s)
        if entry is None:
            ok = os.path.exists(os.path.join(ROOT, PORT_PKG, "cli", s))
        elif isinstance(entry, str):
            ok = entry.startswith(("not ported: ", PENDING_BENCHMARK))
        else:
            tool, flag = entry
            path = os.path.join(ROOT, PORT_PKG, tool)
            ok = os.path.exists(path) and (flag is None or f'"{flag}"' in open(path).read())
        if not ok:
            unported.append(s)
    assert not unported, f"scripts without a port or a reason: {unported}"
    assert [s for s, e in SCRIPTS.items() if e == PENDING_BENCHMARK] == ["bench_latency.py"]


def _pallas_functions(jax_root: str) -> set:
    """(module, top-level function) of every pl.pallas_call in the JAX
    package."""
    found = set()
    for module in modules(jax_root):
        path = os.path.join(jax_root, module)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for fn in tree.body:
            if isinstance(fn, ast.FunctionDef) and any(
                    isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                    for n in ast.walk(fn)):
                found.add((module, fn.name))
    return found


def test_tables_name_what_exists():
    """Every table entry names a JAX function or class that exists and,
    for RENAMES and PALLAS, a port name that exists; PALLAS holds exactly
    the functions that reach pl.pallas_call; every SCRIPTS key is a
    script."""
    jax_root, port_root = os.path.join(ROOT, JAX_PKG), os.path.join(ROOT, PORT_PKG)
    for table in (RENAMES, PALLAS, NOT_PORTED):
        for module, name in table:
            assert name in top_level(os.path.join(jax_root, module), public=False), \
                (module, name)
    for key, (module, name) in {**RENAMES, **PALLAS}.items():
        assert has(port_root, module, name), (key, module, name)
    assert set(PALLAS) == _pallas_functions(jax_root)
    for module in MODULES.values():
        assert os.path.exists(os.path.join(port_root, module)), module
    assert all(os.path.exists(os.path.join(ROOT, "scripts", s)) for s in SCRIPTS)


def test_checker_finds_a_missing_name(tmp_path):
    """On a synthetic pair of trees the checker names the one function the
    port lacks, a module the port lacks altogether, and nothing else."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root, files in ((jax_root, {"a.py": "def f():\n    pass\n\n\nclass G:\n    pass\n\n\n"
                                            "def _private():\n    pass\n",
                                    "sub/b.py": "def h():\n    pass\n"}),
                        (port_root, {"a.py": "class G:\n    pass\n"})):
        for rel, text in files.items():
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_text(text)
    assert modules(str(jax_root)) == ["a.py", "sub/b.py"]
    assert missing(str(jax_root), str(port_root), "a.py", tables=()) == ["f"]
    assert missing(str(jax_root), str(port_root), "sub/b.py", tables=()) == ["h"]
    assert missing(str(jax_root), str(port_root), "a.py", tables=({("a.py", "f"): ""},)) == []
