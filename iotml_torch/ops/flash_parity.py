"""How the flash kernels' bfloat16 results are held against their plain
versions (``attention.flash_attention_reference`` and
``attention.flash_attention_backward_reference``).  ``chip_smoke.py``
and the card tests use these checks; they run on any device.

Forward, the tensor-core (``wgmma``) design.  O is compared row by row:
each query row's ``‖o − o_plain‖ / ‖o_plain‖`` must stay under 1e-2.
That is what sees a long row: a causal row i averages about i/e keys, so
at T = 65,536 a typical |O| is near 6e-3, under any useful atol, while
one bf16 rounding moves a row by at most 2^-8 of its norm.  Element by
element, against the plain version at the kernel's own 64-row key tile
(``block_k`` 64: P rounded to bf16 at the same running max, so only f32
sum orders and the final rounding differ), rtol 2e-2 / atol 1e-3; at
other blocks P rounds at other maxima, which moves even an element near
0 by up to ~2^-9 of its row's scale, so there rtol = atol = 2e-2 (the FMA
design's bound) and the row check does the work.  LSE: atol 1e-3.

Backward, bfloat16.  dq, dk and dv at rtol 1e-2 / atol 1e-3 in f32.  The
kernels and the plain version sum Q·Kᵀ and dO·Vᵀ in f32 in different
orders, so a p (or ds) that lies within an f32 rounding of the midpoint
between two bf16 values rounds up in one and down in the other.  That one
flip moves a whole output row by one bf16 gap of p (or ds) times the row
of dO, q or k it multiplies, which can pass atol where the output is
small.  ``bwd_rounding_flips`` accepts a row outside the tolerance only
when that is all there is: one p or ds of the row's column, within
``FLIP_MID`` of a bf16 midpoint, whose flip (±one gap) brings every
element of the row back inside the tolerance; and at most one such row
in ``FLIP_ROWS_PER`` (at least 2) of each output.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

WGMMA_O_TOL = dict(rtol=2e-2, atol=1e-3)
OTHER_TILES_O_TOL = dict(rtol=2e-2, atol=2e-2)
#: the ``wgmma`` forward's key tile
KERNEL_KEY_TILE = 64
O_ROW_REL_MAX = 1e-2
LSE_TOL = dict(rtol=0.0, atol=1e-3)
BF16_GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
#: a flip's p or ds lies this close to a bf16 midpoint, in bf16 gaps
FLIP_MID = 1e-2
#: at most one row explained by a flip in this many rows of an output
FLIP_ROWS_PER = 10_000


def _outside(got, want, rtol: float, atol: float) -> torch.Tensor:
    return (got - want).abs() > atol + rtol * want.abs()


def o_row_rel_err(o, want_o) -> float:
    """The largest ``‖o_r − want_r‖ / ‖want_r‖`` over the query rows r of
    [B, T, H, D] outputs (a row with ``want_r = 0`` counts its whole
    ``‖o_r‖``)."""
    got, want = o.double(), want_o.double()
    diff = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    return float(torch.where(norm > 0, diff / norm.clamp_min(1e-300),
                             diff).max())


def wgmma_forward_faults(o, lse, want_o, want_lse,
                         block_k: int = KERNEL_KEY_TILE) -> List[str]:
    """What is wrong with the tensor-core forward's ``(o, lse)`` against
    the plain version's at ``block_k``: [] when every check holds."""
    faults = []
    got, want = o.double(), want_o.double()
    if not bool(torch.isfinite(got).all()):
        faults.append("O not finite")
    o_tol = WGMMA_O_TOL if block_k == KERNEL_KEY_TILE else OTHER_TILES_O_TOL
    bad = _outside(got, want, **o_tol)
    if bool(bad.any()):
        faults.append(f"O: {int(bad.sum())} of {bad.numel()} outside "
                      f"{o_tol}; max abs diff "
                      f"{float((got - want).abs().max())}")
    rel = o_row_rel_err(o, want_o)
    if not rel <= O_ROW_REL_MAX:
        faults.append(f"O: a row's relative error {rel} > {O_ROW_REL_MAX}")
    bad = _outside(lse.double(), want_lse.double(), **LSE_TOL)
    if bool(bad.any()) or not bool(torch.isfinite(lse).all()):
        faults.append(f"LSE: {int(bad.sum())} of {bad.numel()} outside "
                      f"{LSE_TOL}")
    return faults


def check_wgmma_forward(what: str, o, lse, want_o, want_lse,
                        block_k: int = KERNEL_KEY_TILE) -> dict:
    """Raise AssertionError unless ``wgmma_forward_faults`` is empty;
    return the largest errors: O absolute, O row-relative, LSE absolute."""
    faults = wgmma_forward_faults(o, lse, want_o, want_lse, block_k)
    if faults:
        raise AssertionError(f"{what}: " + "; ".join(faults))
    return {"o": float((o.double() - want_o.double()).abs().max()),
            "o_row_rel": o_row_rel_err(o, want_o),
            "lse": float((lse.double() - want_lse.double()).abs().max())}


def check_rejects_scaled_o(what: str, o, lse, want_o, want_lse,
                           block_k: int = KERNEL_KEY_TILE) -> None:
    """The forward check at ``block_k`` must fail an O scaled by 0.9, and
    an O with only its last query row (of the first batch and head) so
    scaled: a missed rescale late in a sequence."""
    late = o.clone()
    late[0, -1, 0] = (late[0, -1, 0].double() * 0.9).to(o.dtype)
    for name, bad in (("O × 0.9", (o.double() * 0.9).to(o.dtype)),
                      ("last row × 0.9", late)):
        if not wgmma_forward_faults(bad, lse, want_o, want_lse, block_k):
            raise AssertionError(f"{what}: the check passed {name}")


def _gap_and_mid(x):
    """The bf16 gap at each nonzero float64 ``x`` and its distance from
    the midpoint between its two bf16 neighbours, in gaps (0 at the
    midpoint, 0.5 on a bf16 value)."""
    mag = x.abs()
    gap = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    frac = mag / gap - torch.floor(mag / gap)
    return gap, (frac - 0.5).abs()


def _column(q, k, v, o, lse, do, causal: bool, b: int, h: int, at: int,
            of: str):
    """p and ds of one column of the score matrix, in float64: of="key"
    is key ``at`` against every query (the p, ds that dk and dv sum over),
    of="query" is query ``at`` against every key (the ds that dq sums
    over).  Pairs that are not live are 0."""
    f64 = torch.float64
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh, doh, oh = (t[b, :, h].to(f64) for t in (q, k, v, do, o))
    delta = (doh * oh).sum(-1)
    lse_h = lse[b, h].to(f64)
    T = qh.shape[0]
    pos = torch.arange(T, device=q.device)
    if of == "key":
        s = (qh @ kh[at]) * scale
        arg = s - lse_h
        live = pos >= at if causal else torch.ones_like(pos, dtype=bool)
        dp_minus = doh @ vh[at] - delta
    else:
        s = (kh @ qh[at]) * scale
        arg = s - lse_h[at]
        live = pos <= at if causal else torch.ones_like(pos, dtype=bool)
        dp_minus = vh @ doh[at] - delta[at]
    p = torch.where(live, torch.exp(torch.where(live, arg, 0.0)), 0.0)
    return p, p * dp_minus * scale


def bwd_rounding_flips(q, k, v, o, lse, do, got, want, causal: bool,
                       max_rows: Optional[int] = None,
                       rtol: float = BF16_GRAD_TOL["rtol"],
                       atol: float = BF16_GRAD_TOL["atol"]) -> List[dict]:
    """Hold the kernels' ``got = (dq, dk, dv)`` against the plain
    backward's ``want`` ([B, T, H, D]) from the same inputs.  Every row
    (one query's dq, one key's dk or dv) inside rtol/atol passes; a row
    outside must be explained by one rounding flip (the module's note),
    and at most ``max_rows`` rows of each output may be (default: one in
    ``FLIP_ROWS_PER``, at least 2; 0 allows none).  Raises AssertionError
    otherwise; returns each flip: the output and row, what flipped (p or
    ds) at which column index, its distance from the midpoint in gaps, the
    gap, and the row's largest error before and after the flip."""
    flips = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g is None:
            continue
        g64, w64 = g.double(), w.double()
        if not bool(torch.isfinite(g64).all()):
            raise AssertionError(f"{name} not finite")
        bad = _outside(g64, w64, rtol, atol).any(dim=-1)  # [B, T, H]
        rows = bad.nonzero().tolist()
        cap = max_rows if max_rows is not None else max(
            2, bad.numel() // FLIP_ROWS_PER)
        if len(rows) > cap:
            raise AssertionError(
                f"{name}: {len(rows)} rows outside rtol {rtol} atol {atol}, "
                f"more than the {cap} that rounding flips may explain; max "
                f"abs diff {float((g64 - w64).abs().max())}")
        for b, t, h in rows:
            p, ds = _column(q, k, v, o, lse, do, causal, b, h, t,
                            "query" if name == "dq" else "key")
            x, of = (p, "p") if name == "dv" else (ds, "ds")
            mult = {"dq": k, "dk": q, "dv": do}[name][b, :, h].double()
            err = g64[b, t, h] - w64[b, t, h]
            tol = atol + rtol * w64[b, t, h].abs()
            nonzero = x != 0
            gap, mid = _gap_and_mid(torch.where(nonzero, x, 1.0))
            near = (nonzero & (mid <= FLIP_MID)).nonzero().flatten()
            # each candidate's flip, both ways: [2, candidates, D]
            sign = torch.tensor([1.0, -1.0], dtype=torch.float64,
                                device=x.device)
            after = err - sign[:, None, None] * (gap[near, None]
                                                 * mult[near])[None]
            ok = (after.abs() <= tol).all(dim=-1)
            if not bool(ok.any()):
                raise AssertionError(
                    f"{name} row (b={b}, t={t}, h={h}): max abs diff "
                    f"{float(err.abs().max())} outside rtol {rtol} atol "
                    f"{atol}, and no single {of} rounding flip among "
                    f"{len(near)} near a bf16 midpoint explains it")
            # the explaining candidate nearest its midpoint
            s, c = ok.nonzero()[mid[near][ok.nonzero()[:, 1]].argmin()]
            i = int(near[c])
            flips.append({"output": name, "b": b, "row": t, "h": h,
                          "flip_of": of, "at": i,
                          "mid_distance": float(mid[i]),
                          "gap": float(gap[i]), "sign": float(sign[s]),
                          "err_before": float(err.abs().max()),
                          "err_after": float(after[s, c].abs().max())})
    return flips
