"""Plain Market-1501 evaluation (upstream centroids-reid
``utils/reid_metric.py::eval_func``, the protocol of Zheng et al., ICCV
2015): per query, gallery entries of its pid and camera are discarded;
queries left with no positive are dropped; CMC is the rank of the first
hit among the kept entries; AP is the mean of the precision at each hit.
The gallery order is the stable ascending sort of exact fp32 squared
euclidean distances (TF32 off, or on for the control), computed in blocks
of queries so that no [Q, G] matrix is held. Departure: the upstream code
sorts with numpy's unstable argsort; ties here keep the gallery order.

A program that computes the same fp32 distances in another summation order
ranks near-ties within its rounding differently, and every such swap moves
an AP; so beside the exact metrics the reference gives the range each AP,
the mAP and the CMC can take over every order within ``band`` of its
distances."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    """TF32 for cuBLAS and cuDNN on or off inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def evaluate(qf, gf, q_pids, g_pids, q_cams, g_cams, max_rank: int = 50,
             block: int = 32, tf32: bool = False, band: float = 0.0) -> dict:
    """Card tensors qf [Q, D], gf [G, D] (already normalised), int64 card
    tensors of pids and cameras -> {"mAP", "cmc" [max_rank], "ap" [Q]
    (NaN for a dropped query), "ap_lo", "ap_hi", "first_lo",
    "first_hi"}. The bounds are those of every order that a change of
    each distance by at most ``band`` could give: each hit ranked after
    all kept entries closer by more than ``band`` and before all farther
    by more than ``band``. With ``band`` 0 they equal the exact ones."""
    gn = (gf * gf).sum(1)
    q, dev = qf.shape[0], qf.device
    out = {k: torch.full((q,), float("nan"), dtype=torch.float64,
                         device=dev) for k in ("ap", "ap_lo", "ap_hi")}
    for k in ("first", "first_lo", "first_hi"):
        out[k] = torch.full((q,), -1, dtype=torch.int64, device=dev)
    with tf32_mode(tf32):
        for s in range(0, q, block):
            sl = slice(s, s + block)
            qb = qf[sl]
            d = (qb * qb).sum(1)[:, None] + gn[None, :] - 2.0 * (qb @ gf.T)
            d, order = torch.sort(d, dim=1, stable=True)
            same = g_pids[order] == q_pids[sl, None]
            keep = ~(same & (g_cams[order] == q_cams[sl, None]))
            hit = same & keep
            ckeep = torch.nn.functional.pad(torch.cumsum(keep, 1), (1, 0))
            m = hit.sum(1)
            hmax = max(int(m.max()), 1)
            rows, cols = torch.nonzero(hit, as_tuple=True)
            j = torch.cumsum(hit, 1)[rows, cols] - 1
            dv = torch.full((qb.shape[0], hmax), float("inf"), device=dev)
            exact = torch.zeros((qb.shape[0], hmax), dtype=torch.int64,
                                device=dev)
            dv[rows, j] = d[rows, cols]
            exact[rows, j] = ckeep[rows, cols]
            valid_h = torch.arange(hmax, device=dev)[None, :] < m[:, None]
            lo = ckeep.gather(1, torch.searchsorted(d, dv - band))
            hi = ckeep.gather(1, torch.searchsorted(d, dv + band,
                                                    right=True)) - 1
            idx = torch.arange(hmax, device=dev)[None, :]
            big = torch.iinfo(torch.int64).max // 4
            p_lo = idx + torch.cummax(torch.where(valid_h, lo - idx, -big),
                                      1).values
            p_hi = idx + torch.cummin(torch.where(valid_h, hi - idx, big)
                                      .flip(1), 1).values.flip(1)
            for key, pos in (("ap", exact), ("ap_hi", p_lo),
                             ("ap_lo", p_hi)):
                prec = (idx + 1).double() / (pos + 1).double()
                ap = torch.where(valid_h, prec, 0.0).sum(1) \
                    / m.clamp_min(1)
                out[key][sl] = torch.where(m > 0, ap, float("nan"))
            for key, pos in (("first", exact), ("first_lo", p_lo),
                             ("first_hi", p_hi)):
                out[key][sl] = torch.where(m > 0, pos[:, 0], -1)
    valid = out["first"] >= 0
    ranks = torch.arange(max_rank, device=dev)

    def cmc(first):
        return ((first[valid, None] <= ranks[None, :]).sum(0).double()
                / int(valid.sum())).cpu().numpy()

    res = {k: v.cpu().numpy() for k, v in out.items()}
    res.update(mAP=float(out["ap"][valid].mean()), cmc=cmc(out["first"]),
               cmc_lo=cmc(out["first_hi"]), cmc_hi=cmc(out["first_lo"]),
               map_lo=float(out["ap_lo"][valid].mean()),
               map_hi=float(out["ap_hi"][valid].mean()))
    return res
