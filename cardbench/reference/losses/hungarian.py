"""Exact linear sum assignment of the DETR matcher in plain PyTorch: the
port's `losses/hungarian.py:hungarian_plain` (Jonker-Volgenant shortest
augmenting paths, the computation kernel H1 makes step for step)."""
from __future__ import annotations

import torch
import torch.nn.functional as F



def pad_and_sanitize(cost: torch.Tensor) -> torch.Tensor:
    """cost [P, NQ, NG] (NG <= NQ) -> [P, NQ, NQ]: zero GT columns up to NQ,
    then every non-finite entry replaced by (|finite max| + 1) * 2 + 1e3, the
    finite maximum taken over the whole padded matrix of its problem. NaN from
    a diverged step and inf from a masked cost would leave the solver without
    a reachable free column; the step's skip guard reports them instead."""
    p, nq, ng = cost.shape
    if ng < nq:
        cost = F.pad(cost, (0, nq - ng))
    finite = torch.isfinite(cost)
    finite_max = torch.where(finite, cost, float("-inf")).amax(dim=(1, 2))
    finite_max = torch.where(torch.isfinite(finite_max), finite_max, 0.0)
    big = (finite_max.abs() + 1.0) * 2.0 + 1e3
    return torch.where(finite, cost, big[:, None, None])


def lap_jv_rect(cost: torch.Tensor, num_rows: torch.Tensor,
                steps: torch.Tensor | None = None) -> torch.Tensor:
    """Rectangular LAP of P problems at once: cost [P, M, N] f32, num_rows [P]
    -> col4row [P, M] int64, the column of each of the first num_rows[p] rows
    of problem p, -1 for the other rows. Given `steps` (int64 [P]), adds to
    it the Dijkstra steps each problem took (the work a bound counts).

    The JAX package's `lap_jv_rect` under `vmap`, op for op: the reduced
    cost ((min_val + cost[i]) - u[i]) - v in f32, argmin's first index on
    ties, the `it <= n` bounds of both inner loops, the dual updates with
    spc[col4row] read before the augmentation. Each loop runs while any
    problem is still in it; masks freeze the problems that are done. Indices
    are clamped where a frozen problem's state would read out of range; those
    reads are discarded.
    """
    p, m, n = cost.shape
    dev = cost.device
    ar = torch.arange(p, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    r = torch.zeros(p, dtype=torch.int64, device=dev)
    u = torch.zeros((p, m), dtype=torch.float32, device=dev)
    v = torch.zeros((p, n), dtype=torch.float32, device=dev)
    col4row = torch.full((p, m), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((p, n), -1, dtype=torch.int64, device=dev)
    while True:
        active = r < num_rows
        if not bool(active.any()):
            return col4row
        rc = r.clamp(max=m - 1)

        # Dijkstra from row r over the columns
        i = rc.clone()
        min_val = torch.zeros(p, dtype=torch.float32, device=dev)
        spc = torch.full((p, n), float("inf"), dtype=torch.float32, device=dev)
        sc = torch.zeros((p, n), dtype=torch.bool, device=dev)
        sink = torch.where(active, -1, 0)
        path = torch.full((p, n), -1, dtype=torch.int64, device=dev)
        sr = torch.zeros((p, m), dtype=torch.bool, device=dev)
        it = torch.zeros(p, dtype=torch.int64, device=dev)
        while True:
            run = (sink < 0) & (it <= n)
            if not bool(run.any()):
                break
            it = torch.where(run, it + 1, it)
            sr = sr | (run[:, None] & (rows == i[:, None]))
            red = ((min_val[:, None] + cost[ar, i]) - u[ar, i][:, None]) - v
            better = run[:, None] & ~sc & (red < spc)
            spc = torch.where(better, red, spc)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, spc)
            j = masked.argmin(dim=1)
            min_val = torch.where(run, masked[ar, j], min_val)
            sc = sc | (run[:, None] & (cols == j[:, None]))
            r4c = row4col[ar, j]
            new_sink = torch.where(r4c < 0, j, -1)
            sink = torch.where(run, new_sink, sink)
            i = torch.where(run & (new_sink < 0), r4c, i)
        if steps is not None:
            steps += torch.where(active, it, 0)
        # if the bound tripped, the first free column (0 if there is none)
        free = (row4col >= 0).to(torch.int64).argmin(dim=1)
        sink = torch.where(sink < 0, free, sink)

        # dual updates
        u_new = torch.where(rows == rc[:, None], u + min_val[:, None], u)
        other = sr & (rows != rc[:, None])
        spc_c = spc.gather(1, col4row.clamp(min=0))
        u_new = torch.where(other, (u_new + min_val[:, None]) - spc_c, u_new)
        v_new = torch.where(sc, v - (min_val[:, None] - spc), v)
        u = torch.where(active[:, None], u_new, u)
        v = torch.where(active[:, None], v_new, v)

        # augment along the alternating path
        j = sink
        done = ~active
        it = torch.zeros(p, dtype=torch.int64, device=dev)
        c4r, r4c = col4row.clone(), row4col.clone()
        while True:
            go = ~done & (it <= n)
            if not bool(go.any()):
                break
            jc = j.clamp(0, n - 1)
            pj = path[ar, jc]
            i = torch.where(pj >= 0, pj, rc)
            r4c = torch.where(go[:, None] & (cols == jc[:, None]), i[:, None], r4c)
            nxt = c4r[ar, i]
            c4r = torch.where(go[:, None] & (rows == i[:, None]), jc[:, None], c4r)
            done = done | (go & (i == rc))
            j = torch.where(go, nxt, j)
            it = torch.where(go, it + 1, it)
        col4row = torch.where(active[:, None], c4r, col4row)
        row4col = torch.where(active[:, None], r4c, row4col)
        r = torch.where(active, r + 1, r)


def hungarian_plain(cost: torch.Tensor, num_gt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel H1, the JAX package's `hungarian_device`:
    cost [P, NQ, NG] (NG <= NQ), num_gt [P] (clamped to [0, NG]) -> match
    [P, NQ] int64, the GT index assigned to each query, or -1. Pads the GT
    side to NQ with zeros, sanitises, transposes (rows are the GT planes) and
    solves each problem with Jonker-Volgenant (`lap_jv_rect`)."""
    p, nq, ng = cost.shape
    if ng > nq:
        raise ValueError(f"hungarian takes at most as many GT planes as queries, got "
                         f"NQ {nq}, NG {ng}")
    if p == 0 or nq == 0:
        return torch.full((p, nq), -1, dtype=torch.int64, device=cost.device)
    cost_t = pad_and_sanitize(cost.to(torch.float32)).transpose(1, 2)  # rows: GT planes
    col4gt = lap_jv_rect(cost_t, num_gt.to(torch.int64).clamp(0, ng))
    # invert: match[p, col4gt[p, g]] = g; the unassigned GT slots write to a spare column
    valid = col4gt >= 0
    g = torch.arange(nq, device=cost.device).expand(p, nq)
    match = torch.full((p, nq + 1), -1, dtype=torch.int64, device=cost.device)
    match.scatter_(1, torch.where(valid, col4gt, nq), torch.where(valid, g, -1))
    return match[:, :nq]


def hungarian(cost: torch.Tensor, num_gt: torch.Tensor) -> torch.Tensor:
    """cost [P, NQ, NG], num_gt [P] int64 -> match [P, NQ] int64 (`hungarian_plain`)."""
    return hungarian_plain(cost.detach().to(torch.float32), num_gt)
