"""Cells cut to a size the CPU runs in seconds, for the tests: 4 frames of
128x160 a batch, a ring of 4 batches; the configurations keep their
variants, their bf16 compute and their folding, and keep the stem kernel
(whose plain version runs on the CPU) where img_size stays 224."""

from __future__ import annotations

from posebench import cells, serve, trace

# the harness's own counts, cut for the CPU, in every test process that
# runs a tiny cell
serve.RING_MAX, serve.WARMUP_BATCHES = 4, 1
trace.TRACE_BATCHES, trace.TRACE_WARMUP_BATCHES = 2, 1


def tiny_cell(name: str, img: int = 224, frames: int = 4):
    cell = cells.load(name)
    cell.traffic.update(frames_per_batch=frames, frame_hw=[128, 160])
    if img != 224:
        cell.config["pipeline"]["img_size"] = img
        cell.config["fold"] = {"pallas_stem": False, "pallas_layer1": False,
                               "pallas_stages": []}
    return cell


def few_threads():
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
