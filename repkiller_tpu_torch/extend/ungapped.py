"""Ungapped x-drop extension of one direction, in plain torch ops: the
reference version of kernel K2 (csrc/ungapped_xdrop.cu).

Semantics are those of oracle.pipeline._directional_gain (full-window
cumsum, running-max x-drop, first-argmax endpoint), under the contract of
the Pallas kernel (repkiller_tpu/extend/ungapped_pallas.py ``_direction``):

- ``max_extend`` is a multiple of 32 (``ungapped_pallas.py:110``);
- a step is valid when both positions lie in the sequences, their codes
  are < 5 and the seed is valid; N (code 4) is valid but never a match;
- slots at or past ``n_live`` and seeds with ``valid`` false give zeros.

The form is the XLA version's (repkiller_tpu/extend/ungapped.py
``_direction``) in chunks of 32 steps: each chunk advances the (score,
running max, identities) carries with cumsum/cummax along the chunk and
folds the chunk's first-argmax endpoint into the best one found so far.
A seed's results never change once it stops, so each chunk runs over the
seeds still running only, and the loop ends when none is left.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -(1 << 30)
CHUNK = 32


def check_max_extend(max_extend: int) -> None:
    if max_extend < 0 or max_extend % CHUNK:
        raise ValueError(f"max_extend={max_extend}: the ungapped extension "
                         f"needs a non-negative multiple of {CHUNK}")


def direction_plain(px, py, valid, cx, cy, base_off: int, step: int,
                    match: int, mismatch: int, x_drop: int, E: int, n_live, *,
                    count_steps: bool = False) -> Tuple[torch.Tensor, ...]:
    """One direction for all seeds -> (ext, gain, idents) int32[n].

    The base consumed at step g (0-based) is ``cx[px + base_off + step*g]``
    and the same for y (right: base_off=k, step=+1; left: base_off=-1,
    step=-1). ``n_live`` is an int or a 0-d tensor. ``count_steps``
    appends a fourth output: the steps each seed examines, up to and
    including its stop (int32[n])."""
    check_max_extend(E)
    n = px.shape[0]
    dev = px.device
    i32 = torch.int32
    Lx, Ly = cx.shape[0], cy.shape[0]
    u = torch.arange(CHUNK, dtype=i32, device=dev)[None, :]
    best_ext, best, best_id = (torch.zeros(n, dtype=i32, device=dev)
                               for _ in range(3))
    # the seeds still running, by slot, and their carries
    act = torch.nonzero(valid[:min(n, int(n_live))])[:, 0]
    s_carry, rm_carry, id_carry = (torch.zeros(act.shape[0], dtype=i32,
                                               device=dev) for _ in range(3))
    steps = torch.zeros(n, dtype=i32, device=dev)
    for c in range(E // CHUNK):
        if act.shape[0] == 0:
            break
        g = (c * CHUNK + u).to(torch.int64) * step
        gx = (px[act].to(torch.int64) + base_off)[:, None] + g
        gy = (py[act].to(torch.int64) + base_off)[:, None] + g
        xa = cx[gx.clamp(0, max(Lx - 1, 0))].to(i32)
        ya = cy[gy.clamp(0, max(Ly - 1, 0))].to(i32)
        ok = (gx >= 0) & (gx < Lx) & (gy >= 0) & (gy < Ly) & (xa < 5) & (ya < 5)
        eq = ok & (xa == ya) & (xa < 4)

        s = s_carry[:, None] + torch.cumsum(
            torch.where(eq, match, mismatch).to(i32), 1, dtype=i32)
        rm = torch.maximum(rm_carry[:, None],
                           torch.cummax(s.clamp(min=0), 1).values)
        stop = ~ok | (s <= rm - x_drop)
        any_stop = stop.any(1)
        t = torch.where(any_stop, torch.argmax(stop.to(i32), 1).to(i32), CHUNK)
        if count_steps:
            steps[act] += torch.where(any_stop, t + 1, CHUNK)
        ids = id_carry[:, None] + torch.cumsum(eq.to(i32), 1, dtype=i32)
        s_masked = torch.where(u < t[:, None], s, NEG_INF)
        bidx = torch.argmax(s_masked, 1, keepdim=True)          # first argmax
        bw = s_masked.gather(1, bidx)[:, 0]

        better = bw > best[act]                        # strict: ties keep earlier
        up = act[better]
        best[up] = bw[better]
        best_ext[up] = c * CHUNK + bidx[better, 0].to(i32) + 1
        best_id[up] = ids.gather(1, bidx)[better, 0]

        go = ~any_stop
        act = act[go]
        s_carry, rm_carry, id_carry = s[go, -1], rm[go, -1], ids[go, -1]
    if count_steps:
        return best_ext, best, best_id, steps
    return best_ext, best, best_id
