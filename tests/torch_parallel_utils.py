"""Rank functions for the parallel tests of pose6d_tpu_torch: a world of
processes over gloo on the CPU (`run_world`), and what each rank runs.
Imports torch, numpy and the port only, so that the spawned processes do
not import JAX; the tests import JAX where they hold a run against it."""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

S, N_FRAMES, HW = 64, 12, (64, 64)


def _entry(rank, world, init_file, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp_dir, *args) -> list:
    """fn(rank, *args) in `world` spawned processes joined by a gloo group
    (a file:// rendezvous under tmp_dir, so that concurrent test workers
    never share a port); each rank's return value, in rank order."""
    out_dir = tempfile.mkdtemp(dir=str(tmp_dir))
    init_file = os.path.join(out_dir, "rendezvous")
    mp.spawn(_entry, args=(world, init_file, out_dir, fn, args), nprocs=world, join=True)
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    return out


def digest(tensors) -> str:
    """A hash of the bytes of tensors, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _rotations(q: np.ndarray) -> np.ndarray:
    """Rotation matrices [n, 3, 3] of quaternions [n, 4] (xyzw, normalized
    here)."""
    x, y, z, w = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def seeded_store(seed: int, flavor: str):
    """A seeded resident split of N_FRAMES frames at HW (uint8 RGB, uint16
    depth, boxes, poses, ids, intrinsics) on the CPU."""
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore

    rng = np.random.default_rng(seed)
    n, (h, w) = N_FRAMES, HW
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depth = rng.integers(400, 1400, (n, h, w)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.05] = 0
    bw, bh = rng.uniform(14, 30, n), rng.uniform(14, 30, n)
    bbox = np.stack([rng.uniform(0, w - bw), rng.uniform(0, h - bh), bw, bh], -1)
    rot = _rotations(rng.normal(size=(n, 4)))
    trans_mm = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                         rng.uniform(600, 1000, n)], -1)
    K = np.tile(np.array([[572.4114, 0, w / 2], [0, 573.57043, h / 2], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    return DeviceFrameStore(rgb, depth, bbox, rot, trans_mm, rng.integers(0, 3, n), K,
                            img_size=S, device="cpu", flavor=flavor)


def initial_state(variant: str, seed: int = 0) -> dict:
    """The flax-rule init of `variant` at S from `seed` (posenet.flax_init_),
    as a state_dict in shared memory: made once by the test, read by every
    rank (the init of rgbd's 70M parameters takes seconds on one thread)."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig, flax_init_

    sd = flax_init_(PoseNet(PoseNetConfig(variant=variant, img_size=S)), seed).state_dict()
    return {k: v.share_memory_() for k, v in sd.items()}


def train_step_run(variant: str, batch: int, dtype, init: dict, mesh_shape=None,
                   seed: int = 0):
    """One device-preprocess train step of `variant` at S from the state
    `init` (initial_state), dropout and augmentation on, the global batch
    `batch` drawn from seeded_store(seed): without a mesh, or on make_mesh(
    mesh_shape) in this process's world. Returns {"loss", "grad_norm",
    "grads", "state" (both one-process layout, gathered), "data_index",
    "model_index"} and on a mesh "digest" (of this rank's parameters and
    buffers) and "replicated" (of its replicated ones)."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.parallel import gather_params, make_mesh, param_spec, shard_state
    from pose6d_tpu_torch.train import loop

    cfg = loop.TrainConfig(variant=variant, img_size=S, batch_size=batch)
    with torch.device("meta"):
        model = PoseNet(loop.pose_config(cfg))
    model = model.to_empty(device="cpu")
    model.load_state_dict(init, strict=True)
    state = loop.create_train_state(cfg, model=model.to(dtype), device="cpu")
    mesh = None
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape)
        state = shard_state(state, mesh)
    store = seeded_store(seed, "rgbd" if variant.startswith("rgbd") else "rgb")
    rng = np.random.default_rng(seed + 1)
    meta = store.meta_batch(rng.integers(0, N_FRAMES, batch), rng)
    step = loop.make_train_step(cfg, device_preprocess=True, frame_hw=HW, mesh=mesh)
    g = torch.Generator().manual_seed(seed)
    with torch.backends.mkldnn.flags(enabled=False):
        state, metrics = step(state, store.rgb_frames, store.depth_frames, meta, g)
    model = state.model
    del state  # AdamW's moments: the comparisons need the parameters and gradients only
    grads = {n: p.grad for n, p in model.named_parameters()}
    sd = model.state_dict()
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "data_index": 0, "model_index": 0}
    if mesh is not None:
        # the replicated tensors' digest, and the split ones' (together:
        # every tensor of the rank)
        split = [param_spec(k, v, mesh.tp > 1) is not None for k, v in sd.items()]
        out["replicated"] = digest([v for v, s in zip(sd.values(), split) if not s])
        out["digest"] = (out["replicated"], digest([v for v, s in zip(sd.values(), split) if s]))
        grads, sd = gather_params(grads, mesh), gather_params(sd, mesh)
        out.update(data_index=mesh.data_index, model_index=mesh.model_index)
        if not mesh.is_primary:
            return out
    out.update(grads=grads, state={k: v.detach() for k, v in sd.items()})
    return out


def train_step_rank(rank, variant, batch, init, refs, mesh_shape, seed=0):
    """train_step_run on the mesh for each dtype of refs ({dtype: the
    one-process run, its tensors in shared memory}); rank 0 holds the
    gathered result against the reference (compare_step). Returns per
    dtype {"digest", "model_index", and on rank 0 "errors", "worst"}."""
    out = {}
    for dtype, ref in refs.items():
        got = train_step_run(variant, batch, dtype, init, mesh_shape, seed)
        res = {k: got[k] for k in ("digest", "replicated", "model_index", "data_index")}
        if rank == 0:
            res.update(compare_step(ref, got, variant, dtype))
        out[dtype] = res
        del got
    return out


TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
ZERO_GRAD = {torch.float64: 1e-12, torch.float32: 1e-6}


def compare_step(ref: dict, got: dict, variant: str, dtype) -> dict:
    """A mesh step's gathered result against the one-process step's:
    the loss (TOL relative in float64, 1e-5 in f32), the gradient norm and
    every gradient leaf (TOL[dtype] relative per leaf), and in float64
    every parameter and BatchNorm statistic after the step (TOL relative
    per leaf). The zero_grad_leaves are held to |g| <= ZERO_GRAD[dtype] *
    the gradient norm on both sides and, in float64, their parameters to
    the step such noise can take: lr * |g| / eps per element (AdamW's
    first step). Returns {"errors": [what failed], "worst": {kind: (err,
    leaf)}}."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig

    zero = zero_grad_leaves(PoseNet(PoseNetConfig(variant=variant, img_size=S)))
    tol, gn = TOL[dtype], ref["grad_norm"]
    errors, worst = [], {}

    def rel(a, b):
        err, n = (a.double() - b.double()).norm().item(), b.double().norm().item()
        return err / n if n else err

    def hold(kind, name, err, bound):
        if err > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (err, name)
        if not err <= bound:
            errors.append(f"{kind} {name}: {err:.3g} > {bound:.3g}")

    loss_tol = tol if dtype == torch.float64 else 1e-5
    hold("loss", "loss", abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), loss_tol)
    hold("grad_norm", "grad_norm", abs(got["grad_norm"] - gn) / gn, tol)
    if set(got["grads"]) != set(ref["grads"]) or set(got["state"]) != set(ref.get("state",
                                                                                 got["state"])):
        errors.append("the gathered leaves are not the one-process leaves")
        return {"errors": errors, "worst": worst}
    lr, eps = 1e-4, 1e-8
    for k, want in ref["grads"].items():
        g = got["grads"][k]
        if k in zero:
            hold("zero_grad", k, max(g.norm().item(), want.norm().item()) / gn, ZERO_GRAD[dtype])
            if dtype == torch.float64:
                noise = lr * (g.abs() + want.abs()) / eps + 1e-18
                moved = (got["state"][k] - ref["state"][k]).abs()
                hold("zero_grad_param", k, float((moved / noise).max()), 1.0)
        else:
            hold("grad", k, rel(g, want), tol)
    if dtype == torch.float64:
        for k, want in ref["state"].items():
            if k in zero:
                continue
            if want.is_floating_point():
                hold("state", k, rel(got["state"][k], want), tol)
            elif not torch.equal(got["state"][k], want):
                errors.append(f"state {k}: not equal")
    return {"errors": errors, "worst": worst}


def zero_grad_leaves(model) -> set:
    """The biases of dense layers that a train-mode BatchNorm follows: the
    batch mean removes their shift, so their gradient is zero and what a
    step computes for them is rounding noise."""
    from pose6d_tpu_torch.models.resnet import BatchNorm

    params = dict(model.named_parameters())
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            scope, _, leaf = name.rpartition(".")
            prev = leaf.replace("norm", "dense").replace("bn", "conv")
            out.add(f"{scope}.{prev}.bias" if scope else f"{prev}.bias")
    return out & set(params)


def payload_digest(payload: dict) -> str:
    """digest of a one-process checkpoint payload: the model's tensors by
    key, then AdamW's moments and step counts by parameter index."""
    model = payload["model"]
    opt = payload["optimizer"]["state"]
    return digest([model[k] for k in sorted(model)]
                  + [opt[i][k] for i in sorted(opt) for k in sorted(opt[i])])


def trainer_config(**kw):
    from pose6d_tpu_torch.configs.presets import get_preset

    return get_preset("rgb", **{"img_size": S, "batch_size": 8, "epochs": 1, **kw})


def trainer_rank(rank, data, models, runs):
    """Trainer(mesh=shape) on the CPU with the train split resident, for
    each (save_dir, mesh shape, resume_only) of runs in turn: fit(epochs=1),
    or with resume_only try_resume alone. Returns per run {"resumed",
    "start_epoch", "digest" (of the gathered state, the one-process
    layout), "primary"}. A run (save_dir, mesh shape, False, reference)
    is host_epoch's float64 epoch from the host loaders instead, held to
    `reference` (host_epoch's one-process result, in shared memory):
    {"loads", and on rank 0 "errs" (leaf_errors)}."""
    from pose6d_tpu_torch.parallel import gather_state, make_mesh
    from pose6d_tpu_torch.train.trainer import Trainer

    out = []
    for save_dir, mesh_shape, resume_only, *ref in runs:
        tr = Trainer(trainer_config(), data, models, save_dir, seed=0, num_workers=0,
                     mesh=make_mesh(mesh_shape), device_preprocess=not ref, device="cpu")
        try:
            if ref:
                loads, state, val = host_epoch(tr)
                res = {"loads": loads}
                if rank == 0:
                    res["errs"] = leaf_errors({**state, **val}, {**ref[0]["state"],
                                                                 **ref[0]["val"]})
                out.append(res)
                continue
            resumed = tr.try_resume() if resume_only else tr.fit(epochs=1) is not None
            out.append({"resumed": resumed, "start_epoch": tr.start_epoch,
                        "primary": tr.primary, "digest": payload_digest(gather_state(tr.state))})
        finally:
            tr.close()
    return out


def host_epoch(tr):
    """The first epoch of Trainer tr (device_preprocess=False) in float64
    as fit() runs it (train_epoch, then validate, on the seed's generator;
    no checkpoint is written), each loader counting its load_sample calls
    (num_workers 0: one thread). Returns (loads {"train", "val"}, the
    model's state_dict in the one-process layout, the epoch's train loss
    and validation metrics as 0-d tensors)."""
    from pose6d_tpu_torch.parallel import gather_params

    tr.state.model.to(torch.float64)
    loads = {"train": 0, "val": 0}
    for name in loads:
        loader = getattr(tr, f"{name}_loader")

        def counted(idx, rng, name=name, load=loader.load_sample):
            loads[name] += 1
            return load(idx, rng)

        loader.load_sample = counted
    rng = np.random.default_rng(tr.seed)
    metrics = {"train_loss": tr.train_epoch(0, rng)["train_loss"], **tr.validate(rng)}
    sd = tr.state.model.state_dict()
    if tr.mesh is not None:
        sd = gather_params(sd, tr.mesh)
    return loads, sd, {f"epoch/{k}": torch.tensor(v, dtype=torch.float64)
                       for k, v in metrics.items()}


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf, max |got - want| over max(1, max |want|) (float leaves;
    other leaves 0 where equal, inf where not)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    errs = {}
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            errs[k] = 0.0 if torch.equal(g, w) else float("inf")
            continue
        assert g.dtype == w.dtype == torch.float64, (k, g.dtype, w.dtype)
        errs[k] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
    return errs


def pipeline_rank(rank, weights_path, mesh_shape, frames, K, depth, mode, percentile=None):
    """The port's rgbd PosePipeline at S (the weights of
    torch_port_utils.pipeline_weights, conf 0) sharded on
    make_mesh(mesh_shape), in `mode`: "float" (compute f32, an explicit f32
    PoseNetConfig), "float-bf16" (compute bf16 and no pose_cfg, so that the
    towers run in bf16 as the JAX pipeline's default does), "folded"
    (fold_backbones after shard, compute f32), or "int8-before" /
    "int8-after" (quantize_backbones on the request, with `percentile`,
    before / after shard, compute f32). Every rank is called with the whole
    request. Returns the outputs (numpy, the detections dict left out), the
    digest of every output, the dtypes of the towers' last conv outputs (a
    forward hook on each) and, for int8, the towers' activation scales. A
    tuple of modes serves each in this one world: {mode: its return}."""
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.parallel import make_mesh

    if not isinstance(mode, str):
        return {m: pipeline_rank(rank, weights_path, mesh_shape, frames, K, depth, m, percentile)
                for m in mode}
    ystate, pstate = torch.load(weights_path, weights_only=True)
    bf16 = mode == "float-bf16"
    pipe = PosePipeline(PipelineConfig(variant="rgbd", img_size=S, conf_thresh=0.0,
                                       compute_dtype=torch.bfloat16 if bf16 else torch.float32),
                        YoloConfig(num_classes=2, width=0.125), ystate, pstate,
                        None if bf16 else PoseNetConfig(variant="rgbd", img_size=S), device="cpu")
    if mode == "int8-before":
        pipe.quantize_backbones(frames, K, depth, percentile)
    pipe.shard(make_mesh(mesh_shape))
    if mode == "folded":
        pipe.fold_backbones()
    elif mode == "int8-after":
        pipe.quantize_backbones(frames, K, depth, percentile)
    tower_dtypes = []
    hooks = [getattr(pipe.posenet, name).layer4_2.conv3.register_forward_hook(
        lambda m, a, out: tower_dtypes.append(out.dtype)) for name in pipe.posenet.towers]
    out = pipe(frames, K, depth)
    for h in hooks:
        h.remove()
    flat = {k: v for k, v in out.items() if k != "detections"}
    scales = {name: {conv: float(e["a"]) for conv, e in tree.items()}
              for name, tree in pipe._quantized.items()}
    return {"out": {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                    for k, v in flat.items()},
            "scales": scales, "tower_dtypes": tower_dtypes,
            "digest": digest(list(flat.values())
                             + [out["detections"][k] for k in sorted(out["detections"])])}


def mesh_rank(rank):
    """make_mesh's shapes, coordinates and groups on this world of 8, and
    the error of a shape that does not cover it."""
    from pose6d_tpu_torch.parallel import make_mesh

    out = {}
    for shape in (None, (4, 2), (2, 4), (1, 8)):
        m = make_mesh(shape)
        out[shape] = (m.shape, m.data_index, m.model_index, m.data_group.ranks,
                      m.model_group.ranks, m.data_group.index, m.model_group.index)
    try:
        make_mesh((3, 2))
    except ValueError as e:
        out["error"] = str(e)
    return out


def shard_gather_rank(rank, mesh_shape, variants):
    """shard_gather_run for each variant in turn."""
    return {v: shard_gather_run(mesh_shape, v) for v in variants}


def shard_gather_run(mesh_shape, variant):
    """shard_params -> gather_params and shard_state -> gather_state (after
    an AdamW step, so that the moments are not empty) on a seeded PoseNet
    of `variant`, each against the one-process tensors: the names of the
    tensors that differ, the split names and this rank's slice shapes."""
    from pose6d_tpu_torch.parallel import (gather_params, gather_state, make_mesh, param_spec,
                                           shard_params, shard_state)
    from pose6d_tpu_torch.train import loop

    mesh = make_mesh(mesh_shape)
    cfg = loop.TrainConfig(variant=variant, img_size=S)
    state = loop.create_train_state(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    state.tx.adamw.step()
    full_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    full_opt = state.tx.state_dict()
    local = shard_params(full_sd, mesh)
    bad = [k for k, v in gather_params(local, mesh).items() if not torch.equal(v, full_sd[k])]
    sharded = shard_state(state, mesh)
    back = gather_state(sharded)
    bad += [f"state {k}" for k, v in back["model"].items() if not torch.equal(v, full_sd[k])]
    for i, s in full_opt["state"].items():
        for k, v in s.items():
            if not torch.equal(back["optimizer"]["state"][i][k], v):
                bad.append(f"optimizer {i} {k}")
    split = sorted(k for k, v in full_sd.items() if param_spec(k, v, mesh.tp > 1) is not None)
    shapes = {k: tuple(v.shape) for k, v in sharded.model.state_dict().items() if k in split}
    return {"bad": bad, "split": split, "shapes": shapes}


def collectives_rank(rank, mesh_shape):
    """A float64 block with every collective and its gradient, on the mesh
    and in one process from the same seeded tensors: a column-parallel
    Linear -> ShardedLayerNorm -> GELU -> row-parallel Linear -> a
    BatchNorm over the data group (train mode) plus a skip -> gather_rows.
    Returns the
    largest relative differences of the outputs and of every gradient
    (data-parallel gradients all-reduced as a mean, as the optimizer does),
    and, with torch.distributed.nn's all_reduce (whose backward all-reduces
    again) in place of reduce_from_group, the ratio its first-layer
    gradient comes out at."""
    import torch.distributed.nn.functional as dist_fn
    import torch.nn.functional as F
    from torch import nn

    from pose6d_tpu_torch.models.resnet import BatchNorm
    from pose6d_tpu_torch.parallel import heads, make_mesh
    from pose6d_tpu_torch.parallel.collectives import all_reduce_, gather_rows
    from pose6d_tpu_torch.parallel.mesh import local_rows

    mesh = make_mesh(mesh_shape)
    torch.manual_seed(0)
    B, K, H, O = 8, 6, 8, 5
    x = torch.randn(B, K, dtype=torch.float64)
    c = torch.randn(B, O, dtype=torch.float64)
    lin1, ln, lin2 = nn.Linear(K, H), nn.LayerNorm(H, eps=1e-6), nn.Linear(H, O)
    bn = BatchNorm(O)
    for m in (lin1, ln, lin2, bn):
        m.double()
        for p in m.parameters():
            p.data.normal_()

    def block(xx, l1, norm, l2, b):
        y = l2(F.gelu(norm(l1(xx))))
        return b(y) + y  # the skip keeps the bias of l2 in the gradient

    xf = x.clone().requires_grad_()
    ref = block(xf, lin1, ln, lin2, bn)
    ((ref * c).sum(0) / B).sum().backward()
    ref_grads = {"x": xf.grad.clone(), **{f"{n}.{k}": p.grad.clone() for n, m in
                                          (("lin1", lin1), ("ln", ln), ("lin2", lin2), ("bn", bn))
                                          for k, p in m.named_parameters()}}

    def sharded_run(reduce_fn=None):
        ln.zero_grad(set_to_none=True)  # ShardedLayerNorm shares its parameters
        g = mesh.model_group
        col, row = heads.ColumnParallelLinear(lin1, g), heads.RowParallelLinear(lin2, g)
        if reduce_fn is not None:
            def forward(h):
                return reduce_fn(F.linear(h, row.weight), group=g.pg) + row.bias

            row.forward = forward
        norm = heads.ShardedLayerNorm(ln, g, H // g.size)
        b = BatchNorm(O).double()
        b.load_state_dict(bn.state_dict())
        b = heads.ShardedBatchNorm(b, mesh.data_group if mesh.dp > 1 else None)
        rows = local_rows(B, mesh)
        xl = x[rows].clone().requires_grad_()
        out = block(xl, col, norm, row, b)
        # each rank's objective is the mean over its rows; the global one
        # is their mean over the data group
        ((out * c[rows]).sum(0) / (B // mesh.dp)).sum().backward()
        params = {"lin1": col, "ln": norm, "lin2": row, "bn": b}
        grads = {}
        for n, m in params.items():
            for k, p in m.named_parameters():
                gr = all_reduce_(p.grad.clone(), mesh.data_group) / mesh.dp
                if n == "lin1" or (n == "lin2" and k == "weight"):
                    dim = 1 if n == "lin2" else 0
                    gr = gather_rows(gr.movedim(dim, 0).contiguous(), g).movedim(0, dim)
                grads[f"{n}.{k}"] = gr
        grads["x"] = gather_rows(xl.grad / mesh.dp, mesh.data_group)
        return out, xl, grads

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out, xl, grads = sharded_run()
    errs = {"out": rel(gather_rows(out.detach(), mesh.data_group), ref.detach())}
    errs.update({k: rel(grads[k], v) for k, v in ref_grads.items()})
    # gather_rows' backward: an objective every rank computes from the
    # gathered rows gives each rank its rows' gradient of the whole
    xg = x[local_rows(B, mesh)].clone().requires_grad_()
    (gather_rows(xg * 2.0, mesh.data_group) * x).sum().backward()
    errs["gather_rows_backward"] = rel(xg.grad, 2.0 * x[local_rows(B, mesh)])
    _, _, wrong = sharded_run(dist_fn.all_reduce)
    ratio = (wrong["lin1.weight"].norm() / ref_grads["lin1.weight"].norm()).item()
    return {"errs": errs, "wrong_ratio": ratio}


def jax_step_rank(rank, variant, state_dict, batch, mesh_shape, seed=0):
    """torch_port_utils.one_train_step_both's port step on the mesh: the
    same state_dict (from the flax variables) and expanded batch, dropout
    off (rate 0), train_augment replaced by the eval normalization,
    clipping out of reach, oneDNN off; in f32 and float64. Rank 0 returns,
    per dtype, the gathered gradients, the state after the step and the
    metrics."""
    from unittest import mock

    from pose6d_tpu_torch.models.posenet import Dropout, PoseNet, PoseNetConfig
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.parallel import gather_params, make_mesh, shard_batch, shard_state
    from pose6d_tpu_torch.train import loop

    mesh = make_mesh(mesh_shape)
    B = len(batch["rgb"])
    local = shard_batch(batch, mesh)  # the host-path step takes this rank's rows
    cfg = loop.TrainConfig(variant=variant, img_size=S, batch_size=B, grad_clip=1e9)
    out = {}
    with mock.patch.object(loop, "train_augment",
                           lambda g, rgb, c, rows=None: eval_preprocess(rgb)):
        step = loop.make_train_step(cfg, mesh=mesh)
        for dtype in (torch.float32, torch.float64):
            model = PoseNet(PoseNetConfig(variant=variant, img_size=S))
            model.load_state_dict(state_dict, strict=True)
            for m in model.modules():
                if isinstance(m, Dropout):
                    m.rate = 0.0
            state = shard_state(loop.create_train_state(cfg, model=model.to(dtype),
                                                        device="cpu"), mesh)
            with torch.backends.mkldnn.flags(enabled=False):
                state, metrics = step(state, local, torch.Generator().manual_seed(seed))
            grads = gather_params({n: p.grad for n, p in state.model.named_parameters()}, mesh)
            sd = gather_params(state.model.state_dict(), mesh)
            if rank == 0:
                out[dtype] = {"grads": {k: v.clone() for k, v in grads.items()},
                              "state": {k: v.clone() for k, v in sd.items()},
                              "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"])}
    return out
