"""Inputs the benchmark makes from the seed, on the card, in a few large
draws. Both sides of every comparison are handed these same tensors."""

from __future__ import annotations

import torch


def embeddings(spec: dict, own: int, gen, dim: int = 2048):
    """Unit rows on the card: ``own`` rows around ``spec["pids"]`` identity
    centres (noise ``own_noise``), then ``spec["distractors"]`` rows around
    centres drawn at random (noise ``distractor_noise``); returns (rows
    [own + distractors, D] fp32, the identity of each own row [own])."""
    dev = gen.device
    nd = spec["distractors"]
    centers = torch.randn((spec["pids"], dim), generator=gen, device=dev)
    pid = torch.randint(0, spec["pids"], (own,), generator=gen, device=dev)
    near = torch.randint(0, spec["pids"], (nd,), generator=gen, device=dev)
    rows = torch.empty((own + nd, dim), device=dev)
    rows[:own] = centers[pid] + spec["own_noise"] * torch.randn(
        (own, dim), generator=gen, device=dev)
    step = 100_000
    for s in range(0, nd, step):
        e = min(s + step, nd)
        rows[own + s:own + e] = centers[near[s:e]] + spec[
            "distractor_noise"] * torch.randn((e - s, dim), generator=gen,
                                              device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    return rows, pid
