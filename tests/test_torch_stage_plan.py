"""The plan of the bf16 stage kernel (pose6d_tpu_torch.ops.fused_block
stage_plan), checked on the CPU, where the CUDA kernel cannot run.

For every stage at batches 1, 2, 8 and 32: the GEMMs follow the stage's
blocks in launch order, each tile N divides its N, the K steps of the
splits cover K1 and then K2 exactly once and in order, no K step of a 3x3
GEMM crosses a tap, and the wrapper allocates the split-K workspace and
tickets the plan needs. At batch 8 (the serving batch) every GEMM with fewer
tiles than the H100's 132 SMs splits K and the others do not. A plain
PyTorch emulation of the kernel's split partition (each split's K steps
summed in order, the partials then summed in split order, the 3x3 A tile
gathered tap by tap, the shortcut's rows at (s*oy, s*ox)) holds the plan's
geometry against reference_stage in f32 within 1e-5 of its largest value:
the orders of summation differ, nothing else."""

import pytest
import torch
import torch.nn.functional as F

from pose6d_tpu_torch.ops import fused_block as fb

BATCHES = (1, 2, 8, 32)
CASES = [(stage, batch) for stage in fb.STAGE_CFGS for batch in BATCHES]


def _expected_gemms(stage, batch):
    """(name, M, N, K1, K2, conv3x3) of each GEMM the stage launches."""
    _, n_blocks, stride, cin, cmid, cout, h, w = fb.STAGE_CFGS[stage]
    m_in, m_out = batch * h * w, batch * (h // stride) * (w // stride)
    out = []
    for j in range(n_blocks):
        out += [(f"b{j}.conv1", m_in if j == 0 else m_out, cmid, cin if j == 0 else cout, 0, False),
                (f"b{j}.conv2", m_out, cmid, 9 * cmid, 0, True),
                (f"b{j}.conv3", m_out, cout, cmid, cin if j == 0 else 0, False)]
    return out


@pytest.mark.parametrize("stage,batch", CASES)
def test_plan_follows_the_stage(stage, batch):
    plan = fb.stage_plan(stage, batch)
    assert [(g.name, g.m, g.n, g.k1, g.k2, g.conv3x3) for g in plan] == \
        _expected_gemms(stage, batch)


@pytest.mark.parametrize("stage,batch", CASES)
def test_tile_n_divides_n(stage, batch):
    for g in fb.stage_plan(stage, batch):
        assert g.bn in (64, 128) and g.n % g.bn == 0, g
        assert g.tiles == -(-g.m // fb.TILE_M) * (g.n // g.bn)


@pytest.mark.parametrize("stage,batch", CASES)
def test_k_steps_cover_k_once_in_order(stage, batch):
    for g in fb.stage_plan(stage, batch):
        ranges = [g.split_steps(s) for s in range(g.splits)]
        assert all(len(r) > 0 for r in ranges), g
        steps = [t for r in ranges for t in r]
        assert steps == list(range(g.k_steps)), g
        nk1 = g.k1 // fb.STEP_K
        assert g.k1 % fb.STEP_K == 0 and g.k2 % fb.STEP_K == 0
        k1_starts = [t * fb.STEP_K for t in steps if t < nk1]
        k2_starts = [(t - nk1) * fb.STEP_K for t in steps if t >= nk1]
        assert k1_starts == list(range(0, g.k1, fb.STEP_K))
        assert k2_starts == list(range(0, g.k2, fb.STEP_K))


@pytest.mark.parametrize("stage,batch", CASES)
def test_3x3_steps_stay_inside_one_tap(stage, batch):
    for g in fb.stage_plan(stage, batch):
        if not g.conv3x3:
            continue
        C = g.k1 // 9
        assert g.k2 == 0 and g.k1 == 9 * C
        for t in range(g.k_steps):
            k0 = t * fb.STEP_K
            assert k0 // C == (k0 + fb.STEP_K - 1) // C < 9, (g, t)


@pytest.mark.parametrize("stage", sorted(fb.STAGE_CFGS))
def test_splits_fill_the_card_at_batch_8(stage):
    for g in fb.stage_plan(stage, 8):
        if g.tiles < fb.NUM_SMS:
            assert g.splits > 1, g
        else:
            assert g.splits == 1, g


@pytest.mark.parametrize("stage,batch", CASES)
def test_wrapper_workspace_matches_the_plan(stage, batch):
    """The wrapper's f32 workspace holds the largest split GEMM's
    splits * M * N partials (4 bytes each) and one int32 ticket, zeroed,
    per output tile of the split GEMM with the most tiles; f32 needs
    neither."""
    plan = fb.stage_plan(stage, batch)
    for g in plan:
        assert g.workspace_bytes == (4 * g.splits * g.m * g.n if g.splits > 1 else 0)
    split = [g for g in plan if g.splits > 1]
    want_ws = max((g.splits * g.m * g.n * 4 for g in split), default=0)
    want_tickets = max((g.tiles for g in split), default=0)
    assert fb.stage_workspace(plan) == (want_ws, want_tickets)
    _, _, _, cin, _, _, h, w = fb.STAGE_CFGS[stage]
    for dtype, ws_bytes, n_tickets in ((torch.bfloat16, want_ws, want_tickets),
                                       (torch.float32, 0, 0)):
        x = torch.empty(batch, h, w, cin, dtype=dtype, device="meta")
        scratch, _ = fb._stage_buffers(x, stage)
        ws, tickets = scratch[-2:]
        assert ws.dtype == torch.float32 and ws.numel() * 4 == ws_bytes
        assert tickets.dtype == torch.int32 and tickets.numel() == n_tickets


def _random_stage_weights(stage, seed):
    name, n_blocks, _, cin, cmid, cout, _, _ = fb.STAGE_CFGS[stage]
    g = torch.Generator().manual_seed(seed)
    specs = {f"{name}_0/downsample": (1, cin, cout)}
    for j in range(n_blocks):
        specs.update({f"{name}_{j}/conv1": (1, cin if j == 0 else cout, cmid),
                      f"{name}_{j}/conv2": (3, cmid, cmid), f"{name}_{j}/conv3": (1, cmid, cout)})
    tree = {k: {"w": torch.randn(co, ci, k_, k_, generator=g) * (2.0 / (ci * k_ * k_)) ** 0.5,
                "b": torch.randn(co, generator=g) * 0.1}
            for k, (k_, ci, co) in specs.items()}
    return fb.pack_stage_weights(tree, stage, torch.float32)


def _emulate_gemm(g, a1_step, w1, bias, a2=None, w2=None, bias2=None, res=None):
    """The kernel's arithmetic for one planned GEMM: per split, its K steps
    in order into one f32 accumulator; the partials summed in split order;
    then bias, second bias, residual and ReLU. a1_step(k0) is A1's 64
    columns at k0 (the 3x3 gather for a conv3x3 GEMM)."""
    nk1 = g.k1 // fb.STEP_K
    total = torch.zeros(g.m, g.n)
    for s in range(g.splits):
        acc = torch.zeros(g.m, g.n)
        for t in g.split_steps(s):
            if t < nk1:
                k0 = t * fb.STEP_K
                acc += a1_step(k0) @ w1[k0:k0 + fb.STEP_K]
            else:
                k0 = (t - nk1) * fb.STEP_K
                acc += a2[:, k0:k0 + fb.STEP_K] @ w2[k0:k0 + fb.STEP_K]
        total = total + acc
    out = total + bias
    if bias2 is not None:
        out = out + bias2
    if res is not None:
        out = out + res
    return out.relu()


def _emulate_stage(x, weights, stage):
    """fused_stage's three GEMMs per block as stage.cuh launches them, each
    through _emulate_gemm with its plan entry."""
    _, n_blocks, stride, cin, cmid, cout, h, w = fb.STAGE_CFGS[stage]
    B = x.shape[0]
    ho, wo = h // stride, w // stride
    plan = fb.stage_plan(stage, B)
    it = iter(weights)
    hmap = x
    for j in range(n_blocks):
        g1, g2, g3 = plan[3 * j:3 * j + 3]
        w1, b1, w2, b2, w3, b3 = (next(it) for _ in range(6))
        s = stride if j == 0 else 1
        hh, ww = hmap.shape[1:3]
        dense = hmap.reshape(-1, hmap.shape[-1])
        assert (g1.m, g1.k1) == tuple(dense.shape)
        t1 = _emulate_gemm(g1, lambda k0: dense[:, k0:k0 + fb.STEP_K], w1, b1)
        padded = F.pad(t1.reshape(B, hh, ww, cmid), (0, 0, 1, 1, 1, 1))

        def tap_rows(k0, padded=padded, s=s):
            tap, ci0 = divmod(k0, cmid)
            ky, kx = divmod(tap, 3)
            win = padded[:, ky:ky + s * (ho - 1) + 1:s, kx:kx + s * (wo - 1) + 1:s,
                         ci0:ci0 + fb.STEP_K]
            return win.reshape(-1, fb.STEP_K)

        assert g2.m == B * ho * wo and g2.k1 == w2.shape[0]
        t2 = _emulate_gemm(g2, tap_rows, w2, b2)
        if j == 0:
            wd, bd = next(it), next(it)
            shortcut = hmap[:, ::s, ::s].reshape(-1, cin)
            assert (g3.k1, g3.k2) == (cmid, cin)
            y = _emulate_gemm(g3, lambda k0: t2[:, k0:k0 + fb.STEP_K], w3, b3, shortcut, wd, bd)
        else:
            y = _emulate_gemm(g3, lambda k0: t2[:, k0:k0 + fb.STEP_K], w3, b3,
                              res=hmap.reshape(-1, cout))
        hmap = y.reshape(B, ho, wo, cout)
    return hmap


@pytest.mark.parametrize("stage,batch", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2)])
def test_split_k_emulation_matches_reference_stage(stage, batch):
    """Batch 1 and 2 split K the most (stage 4 at batch 1: 9 splits of its
    3x3 GEMM; stage 1's block 0 conv3 splits between its two pairs)."""
    _, _, _, cin, _, _, h, w = fb.STAGE_CFGS[stage]
    weights = _random_stage_weights(stage, seed=stage)
    x = torch.randn(batch, h, w, cin, generator=torch.Generator().manual_seed(10 + stage))
    assert any(g.splits > 1 for g in fb.stage_plan(stage, batch))
    got = _emulate_stage(x, weights, stage)
    want = fb.reference_stage(x, weights, stage)
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
