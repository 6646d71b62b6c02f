"""The request trace (pose6d_tpu_torch/ops/profile_pipeline.py) on the CPU
at a small size: 160x120 frames (letterboxed onto a 160 canvas), YOLOv8n,
PoseNet at img 64 (the folded rows then fold without the kernels, which
need 224), batch 2, --device cpu, one run of the tool for rgb (bench.py's
row: bf16 float towers), rgbd and rgbd_geometric folded with a trace and
the eval_e2e batch; the unfolded rows rgb, rgb_f32 and rgbd build the
float pipeline with towers in their dtype (a hook sees it). Each row prints its
JSON line with the fields the module docstring states, its full prefix
(request_steps, the pipeline's own methods) equals PosePipeline.__call__
bit for bit, and its stage FLOPs are the port's own counts; the counts of
a ResNet50 tower at 224 (C=3 and C=1) and of YOLOv8n at 640x480 are held
within FLOP_RTOL of XLA's cost analysis of the JAX modules, lowered on the
CPU and never run (XLA counts the convolutions' multiply-adds x 2 without
the padded taps, and the elementwise ops besides: the two counts differ by
a few per cent, not by a factor). The sweeps (--sweep rgb, --sweep rgbd,
the counterparts of scripts/bench_sweep.py and bench_sweep_rgbd.py) run at
batch 2 on 96x64 frames with PoseNet at img 32, each arm printing its
frames/s and reading; the detector's weights cast to bf16 once (the
bf16_params arm) give a request's outputs bit for bit. Without --device
cpu, on a machine with no card, the tool exits 2."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_port_utils import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("rgb", "rgbd_folded", "rgbd_geometric_folded")
BATCH = 2
ARGS = ["--device", "cpu", "--frame-hw", "120", "160", "--img-size", "64", "--det-size", "160",
        "--window", "1", "--reps", "1"]
FLOP_RTOL = 0.05
STAGE_KEYS = {"ms", "host_enqueue_ms", "card_ms", "idle_share", "gflop_per_frame", "peak_share"}
LINE_KEYS = {"row", "name", "batch", "pose_batch", "device", "clock", "tf32", "frame_hw",
             "img_size", "ring", "window", "stages", "sum_isolated_ms", "prefixes", "request",
             "overhead_ms", "sum_isolated_card_ms", "card_overhead_ms",
             "full_prefix_equals_call", "sync_free", "kernel_launches", "top_ops",
             "hand_kernels", "trace"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    trace = tmp_path_factory.mktemp("trace")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pp.main(ARGS + ["--runs", *(f"{r}@{BATCH}" for r in ROWS),
                               "--trace-dir", str(trace), "--eval-batch"]) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()], trace


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_row_line(run, i):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    lines, trace = run
    assert len(lines) == len(ROWS) + 1
    line = lines[i]
    assert set(line) == LINE_KEYS
    row = ROWS[i]
    depth = row != "rgb"
    assert (line["row"], line["batch"], line["pose_batch"]) == (row, BATCH, BATCH)
    assert line["name"] == {"rgb": "rgb_bf16_towers", "rgbd_folded": "rgbd_folded_bf16",
                            "rgbd_geometric_folded": "rgbd_geometric_folded_bf16"}[row]
    assert (line["device"], line["clock"], line["sync_free"]) == ("cpu", "host", None)
    assert line["full_prefix_equals_call"] is True
    # the plain versions run on the CPU: no kernel launches, none traced
    assert line["kernel_launches"] == {} and line["hand_kernels"] == {}

    stages = {"convert", "detector", "decode_nms", "rgb_crop", "posenet", "rgb_tower_heads"}
    stages |= {"depth_crop"} if depth else set()
    stages |= {"depth_tower"} if row == "rgbd_folded" else set()
    assert set(line["stages"]) == stages
    for name, st in line["stages"].items():
        assert set(st) == STAGE_KEYS, name
        assert st["ms"] > 0 and st["host_enqueue_ms"] > 0, name
        assert st["card_ms"] is None and st["idle_share"] is None and st["peak_share"] is None
    summed = sum(line["stages"][k]["ms"] for k in pp.SUMMED if k in line["stages"])
    assert line["sum_isolated_ms"] == pytest.approx(summed)
    assert line["overhead_ms"] == pytest.approx(line["request"]["ms"] - summed)
    assert line["sum_isolated_card_ms"] is None and line["card_overhead_ms"] is None
    assert set(line["request"]) == STAGE_KEYS

    names = [p["name"] for p in line["prefixes"]]
    assert names == ["convert", "+detector", "+decode_nms", "+crop", "+normalize",
                     "+depth_crop" if depth else "+pose_inputs", "+posenet", "+outputs",
                     "__call__"]
    prev = 0.0
    for p in line["prefixes"]:
        assert p["ms"] > 0 and p["delta_ms"] == pytest.approx(p["ms"] - prev)
        prev = p["ms"]

    # the FLOPs are the port's counts: the request's is the summed stages'
    g = {k: v["gflop_per_frame"] for k, v in line["stages"].items()}
    assert g["convert"] == g["decode_nms"] == 0 and g["detector"] > 0 and g["posenet"] > 0
    assert g["rgb_crop"] == pytest.approx(2 * 3 * (120 * 160 * 64 + 64 * 120 * 64) / 1e9)
    assert line["request"]["gflop_per_frame"] == pytest.approx(
        sum(g[k] for k in pp.SUMMED if k in g))

    # the trace: one request, each step in its own range, the ops each calls
    assert line["trace"] == os.path.join(str(trace), f"{row}_b{BATCH}.json")
    with open(line["trace"]) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("name", "").startswith("stage:")}
    assert spans == {f"stage:{n.lstrip('+')}" for n in names[:-1]}
    assert set(line["top_ops"]) == {n.lstrip("+") for n in names[:-1]}
    assert any("conv" in op for op, _, _ in line["top_ops"]["posenet"])


@pytest.mark.parametrize("row,dtype", [("rgb", torch.bfloat16), ("rgb_f32", torch.float32),
                                       ("rgbd", torch.bfloat16)])
def test_float_rows_tower_dtype(row, dtype):
    """The unfolded rows (bench.py's rgb and rgbd rows, and PR 17's rgb as
    rgb_f32): the float pipeline, its towers in the row's dtype, seen by a
    hook on each tower's last conv over one request of the row's ring;
    rgb and rgb_f32 share their weights, rgbd has rgbd_folded's."""
    import numpy as np

    from pose6d_tpu_torch.ops import profile_pipeline as pp

    pipe, name = pp.build_pipeline(row, 32, 640, "cpu")
    variant = pp.ROW_SPECS[row].variant
    assert name == f"{variant}_{'bf16' if dtype == torch.bfloat16 else 'f32'}_towers"
    assert not pipe._folded and not pipe._quantized and pipe.pose_cfg.dtype == dtype
    assert pipe.cfg.nms_pre_topk == (32 if variant == "rgbd" else 64)
    twin = {"rgb": "rgb_f32", "rgb_f32": "rgb", "rgbd": "rgbd_folded"}[row]
    other, _ = pp.build_pipeline(twin, 32, 640, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pipe.posenet.state_dict().values(),
                                                 other.posenet.state_dict().values()))
    seen = []
    for tower in pipe.posenet.towers:
        getattr(pipe.posenet, tower).layer4_2.conv3.register_forward_hook(
            lambda m, a, out: seen.append(out.dtype))
    r = pp.make_ring(pipe, 2, (64, 96), 1, np.random.default_rng(0))[0]
    out = pipe(r["frames"], r["K"], r["depth"])
    assert seen == [dtype] * len(pipe.posenet.towers) and torch.isfinite(out["rotation"]).all()


def test_eval_batch_line(run):
    lines, _ = run
    ev = lines[-1]["eval_batch"]
    assert ev["frames"] == 8 and ev["device"] == "cpu" and ev["request_card_ms"] is None
    parts = ("decode_ms", "ground_truth_ms", "request_enqueue_ms", "request_ms", "metrics_ms")
    assert all(ev[k] > 0 for k in parts)
    assert ev["total_ms"] >= ev["decode_ms"] + ev["ground_truth_ms"] + ev["request_ms"]
    assert ev["addmin_launches"] == 0  # the plain version runs on the CPU


@pytest.mark.parametrize("name", ["void stem_tc_kernel<3>(bf16 const*, bf16 const*)",
                                  "_Z17wgmma_gemm_kernelILi128ELb1EEv6Params",
                                  "void gemm_kernel<false>(float const*)", "addmin_kernel",
                                  "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize",
                                  "void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm>"])
def test_hand_kernel_names(name):
    """The csrc kernels are found under a trace's demangled and mangled
    names, and no library kernel is taken for one."""
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    m = pp.HAND_KERNELS.search(name)
    want = {"void stem_tc_kernel<3>(bf16 const*, bf16 const*)": "stem_tc_kernel",
            "_Z17wgmma_gemm_kernelILi128ELb1EEv6Params": "wgmma_gemm_kernel",
            "void gemm_kernel<false>(float const*)": "gemm_kernel",
            "addmin_kernel": "addmin_kernel"}.get(name)
    assert (m.group(1) if m else None) == want


def _xla_flops(model, shape, **kwargs) -> float:
    import jax
    import jax.numpy as jnp

    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    variables = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros(shape), **kwargs))
    cost = jax.jit(lambda v, a: model.apply(v, a, **kwargs)).lower(variables, x).cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


@pytest.mark.parametrize("what", ["resnet50_c3", "resnet50_c1", "yolov8n_640x480"])
def test_flops_match_xla_cost_analysis(what):
    from pose6d_tpu.models.resnet import ResNet50 as JResNet50
    from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    if what.startswith("resnet50"):
        C = 3 if what.endswith("c3") else 1
        port = pp.tower_flops(C, 224)
        xla = _xla_flops(JResNet50(in_channels=C), (1, 224, 224, C), train=False)
    else:
        port = pp.detector_flops(YoloConfig(), (480, 640))
        xla = _xla_flops(JYoloV8(JYoloConfig(num_classes=13)), (1, 480, 640, 3))
    assert abs(port - xla) <= FLOP_RTOL * xla, (what, port, xla)


def test_refuses_without_a_card():
    """No --device cpu and no card: exit 2, no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")
    r = subprocess.run([sys.executable, "-m", "pose6d_tpu_torch.ops.profile_pipeline",
                        "--runs", "rgb@2"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == "" and "--device cpu" in r.stderr


SWEEP_ARGS = ["--device", "cpu", "--frame-hw", "64", "96", "--img-size", "32", "--window", "1",
              "--reps", "1", "--sweep-batches", "2"]
SWEEP_KEYS = {"rgb": ("baseline_topk64", "topk32", "topk16", "bf16_params"),
              "rgbd": ("b2", "b2_bf16params", "b2_topk32")}
ARM_KEYS = {"name", "batch", "pose_batch", "nms_pre_topk", "bf16_params_cast", "fps", "ms",
            "host_enqueue_ms", "card_ms", "idle_share", "kernel_launches"}
DETECTOR_CASTS = 57 + 6 + 6  # the ConvBNs' weights, the head output convs' weights and biases


@pytest.mark.parametrize("kind", ["rgb", "rgbd"])
def test_sweep_line(kind):
    """--sweep rgb / rgbd (scripts/bench_sweep.py, bench_sweep_rgbd.py) at
    batch 2: the JAX script's keys in frames/s, each arm's reading, the
    bf16_params arm's outputs bit-equal to the pipeline's without the cast
    (the sweep raises otherwise)."""
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pp.main(SWEEP_ARGS + ["--sweep", kind]) == 0
    (line,) = [json.loads(x) for x in out.getvalue().splitlines()]
    keys = SWEEP_KEYS[kind]
    assert line["tool"] == f"sweep_{kind}" and set(line["arms"]) == set(keys)
    assert line["bf16_params_equal"] is True and line["best_batch"] == 2
    for k in keys:
        arm = line["arms"][k]
        assert set(arm) == ARM_KEYS and line[k] == arm["fps"]
        assert arm["fps"] == pytest.approx(2 / (arm["ms"] / 1e3)) and arm["card_ms"] is None
        assert arm["name"] == ("rgb_bf16_towers" if kind == "rgb" else "rgbd_folded_bf16")
        assert arm["bf16_params_cast"] == (DETECTOR_CASTS if "bf16" in k else 0)
        assert arm["nms_pre_topk"] == {"topk32": 32, "topk16": 16}.get(
            k, 64 if kind == "rgb" else 32)


def test_precast_detector_keeps_the_outputs():
    """bf16_params casts every weight the bf16 detector casts at use, once:
    then none is f32, and a request's outputs equal those of the pipeline
    without the cast, bit for bit."""
    import numpy as np

    from pose6d_tpu_torch.models.yolo.modules import ConvBN, OutConv
    from pose6d_tpu_torch.ops import profile_pipeline as pp
    from pose6d_tpu_torch.ops.profile_sweep import precast_detector_bf16

    base, _ = pp.build_pipeline("rgbd_folded", 32, 640, "cpu")
    cast, _ = pp.build_pipeline("rgbd_folded", 32, 640, "cpu")
    assert precast_detector_bf16(cast) == DETECTOR_CASTS
    convs = [m.conv if isinstance(m, ConvBN) else m for m in cast.yolo.modules()
             if isinstance(m, (ConvBN, OutConv))]
    assert all(p.dtype == torch.bfloat16 for c in convs for p in c.parameters())
    ring = pp.make_ring(base, 2, (64, 96), 1, np.random.default_rng(0))[0]
    assert pp._outputs_equal(base(ring["frames"], ring["K"], ring["depth"]),
                             cast(ring["frames"], ring["K"], ring["depth"]))


def test_sweep_refuses_without_a_card(capsys):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")
    assert pp.main(["--sweep", "rgbd"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err
