"""Importance-matrix quantizers for the IQ1/IQ2/IQ3 grid formats.

Bit-faithful numpy ports of the reference encoders
(ggml/src/ggml-quants.c: quantize_iq2_xxs:3652, quantize_iq2_xs:3664,
quantize_iq2_s:5412, quantize_iq3_xxs:4152, quantize_iq3_s:4353,
quantize_iq1_s:4672, quantize_iq1_m:4946).  All of them REQUIRE an
importance matrix (`quant_weights` — per-input-channel activation second
moments; see tools/make_imatrix.py); the reference asserts the same.

Port discipline (same as formats/kquants.py): every C float accumulation
runs as an explicit sequential loop over the small fixed dimension (8/32)
with np.float32 per-op rounding, vectorized across blocks/candidates —
the scalar C arithmetic is reproduced bit-for-bit, and the byte outputs
are asserted equal to libggml's in tests/test_iq_encode.py.

nearest_int() is ggml's 12582912.0f trick = round-half-to-EVEN (np.rint).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .iq_tables import IQTables, tables

QK_K = 256
GROUP_MAX_EPS = np.float32(1e-15)
GROUP_MAX_EPS_IQ3_XXS = np.float32(1e-8)
GROUP_MAX_EPS_IQ2_S = np.float32(1e-8)
GROUP_MAX_EPS_IQ1_S = np.float32(1e-12)
GROUP_MAX_EPS_IQ1_M = np.float32(1e-7)

f32 = np.float32


def _f16(x: np.ndarray) -> np.ndarray:
    """f32 -> f16 -> f32 (GGML_FP32_TO_FP16 round trip value)."""
    return np.asarray(x, np.float32).astype(np.float16)


def nearest_int(v: np.ndarray) -> np.ndarray:
    return np.rint(np.asarray(v, np.float32)).astype(np.int32)


def _seq_sum(terms, n: int):
    """Sequential f32 accumulation over axis -1 (C loop semantics)."""
    acc = np.zeros(terms.shape[:-1], np.float32)
    for i in range(n):
        acc = (acc + terms[..., i]).astype(np.float32)
    return acc


# --------------------------------------------------------------------------
# make_qp_quants (ggml-quants.c:1076) — vectorized over blocks
# --------------------------------------------------------------------------

def make_qp_quants(x: np.ndarray, weights: np.ndarray, nmax: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """x, weights: (B, n) f32, x >= 0.  Returns (scale (B,), L (B, n))."""
    x = np.asarray(x, np.float32)
    w = np.asarray(weights, np.float32)
    B, n = x.shape
    mx = x.max(axis=1)
    dead = mx < GROUP_MAX_EPS

    safe_mx = np.where(dead, 1.0, mx).astype(np.float32)
    iscale = (np.float32(nmax) / safe_mx).astype(np.float32)
    L = nearest_int(iscale[:, None] * x)
    scale = (np.float32(1.0) / iscale).astype(np.float32)
    diff = (x - scale[:, None] * L.astype(np.float32)).astype(np.float32)
    best_mse = _seq_sum((w * diff * diff).astype(np.float32), n)

    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        iscale_is = ((np.float32(0.1) * np.float32(is_) + np.float32(nmax))
                     / safe_mx).astype(np.float32)
        scale_is = (np.float32(1.0) / iscale_is).astype(np.float32)
        l = np.minimum(nmax, nearest_int(iscale_is[:, None] * x))
        diff = (x - scale_is[:, None] * l.astype(np.float32)).astype(np.float32)
        mse = _seq_sum((w * diff * diff).astype(np.float32), n)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        iscale = np.where(better, iscale_is, iscale)

    L = np.minimum(nmax, nearest_int(iscale[:, None] * x))
    Lf = L.astype(np.float32)
    sumlx = _seq_sum((w * x * Lf).astype(np.float32), n)
    suml2 = _seq_sum((w * Lf * Lf).astype(np.float32), n)
    for _ in range(5):
        n_changed = np.zeros(B, bool)
        for i in range(n):
            wi = w[:, i]
            xi = x[:, i]
            Li = L[:, i].astype(np.float32)
            slx = (sumlx - wi * xi * Li).astype(np.float32)
            sl2 = (suml2 - wi * Li * Li).astype(np.float32)
            ok = (slx > 0) & (sl2 > 0)
            # C: nearest_int(x[i] * sl2 / slx) — left-to-right f32
            new_l = np.minimum(nmax, nearest_int(
                (xi * sl2 / np.where(slx == 0, 1, slx)).astype(np.float32)))
            changed = ok & (new_l != L[:, i])
            nlf = new_l.astype(np.float32)
            slx2 = (slx + wi * xi * nlf).astype(np.float32)
            sl22 = (sl2 + wi * nlf * nlf).astype(np.float32)
            accept = changed & ((slx2 * slx2 * suml2)
                                > (sumlx * sumlx * sl22))
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx).astype(np.float32)
            suml2 = np.where(accept, sl22, suml2).astype(np.float32)
            n_changed |= accept
        if not n_changed.any():
            break
    out = np.where(suml2 > 0, sumlx / np.where(suml2 == 0, 1, suml2),
                   np.float32(0.0)).astype(np.float32)
    out = np.where(dead, np.float32(0.0), out)
    L[dead] = 0
    return out, L


# --------------------------------------------------------------------------
# neighbour machinery (padded-gather form of iq2/iq3_find_best_neighbour)
# --------------------------------------------------------------------------

class _NeighLookup:
    def __init__(self, t: IQTables):
        self.t = t
        flat = t.neighbours
        km = t.kmap
        off = np.nonzero(km < 0)[0]
        starts = (-km[off] - 1).astype(np.int64)
        counts = flat[starts].astype(np.int64)
        self.cmax = int(counts.max())
        # per-PATTERN padded neighbour matrix, indexed by kmap slot
        self.pat_start = np.full(len(km), -1, np.int64)
        self.pat_start[off] = starts
        self.pat_count = np.zeros(len(km), np.int64)
        self.pat_count[off] = counts

    def gather(self, u: np.ndarray):
        """u: (G,) pattern ids (all off-grid).  Returns (idx (G, cmax) grid
        indices padded with 0, mask (G, cmax))."""
        starts = self.pat_start[u]
        counts = self.pat_count[u]
        pos = starts[:, None] + 1 + np.arange(self.cmax)[None, :]
        mask = np.arange(self.cmax)[None, :] < counts[:, None]
        idx = self.t.neighbours[np.where(mask, pos, starts[:, None] + 1)]
        return idx.astype(np.int64), mask


_NL_CACHE = {}


def _neigh(kind: str) -> _NeighLookup:
    nl = _NL_CACHE.get(kind)
    if nl is None:
        nl = _NL_CACHE[kind] = _NeighLookup(tables(kind))
    return nl


def _find_best_neighbour(kind: str, u: np.ndarray, xval: np.ndarray,
                         weight: np.ndarray, scale: np.ndarray
                         ) -> np.ndarray:
    """Vectorized iq2/iq3_find_best_neighbour (ggml-quants.c:3270, :3914).

    u: (G,) off-grid pattern ids; xval/weight: (G, K); scale: (G,).
    Returns chosen grid indices (G,).  Weighted distance accumulates
    sequentially in f32; ties keep the FIRST (list is (distance, index)
    ordered, matching the C scan with strict <)."""
    t = tables(kind)
    nl = _neigh(kind)
    idx, mask = nl.gather(u)                    # (G, C)
    pg = t.grid[idx].astype(np.float32)         # (G, C, K)
    K = pg.shape[-1]
    diff = (scale[:, None, None] * pg - xval[:, None, :]).astype(np.float32)
    terms = (weight[:, None, :] * diff * diff).astype(np.float32)
    d2 = _seq_sum(terms, K)
    d2 = np.where(mask, d2, np.float32(np.inf))
    best = d2.argmin(axis=1)                    # first minimum
    return idx[np.arange(len(u)), best]


def _sign_fold(gx: np.ndarray, weight: np.ndarray):
    """Per-8-group sign folding with even-parity repair (the iq2 family's
    shared preamble): xval = |x|, the group's sign byte keeps 7 bits, odd
    parity is fixed by flipping the element with minimal w*x^2.

    gx, weight: (B, n) with n % 8 == 0.  Returns (xval (B, n),
    block_signs (B, n//8) uint32)."""
    B, n = gx.shape
    ng = n // 8
    xval = np.abs(gx).astype(np.float32)
    neg = gx < 0
    s8 = gx.reshape(B, ng, 8)
    w8 = weight.reshape(B, ng, 8)
    signs = (neg.reshape(B, ng, 8).astype(np.uint16)
             << np.arange(8)[None, None, :]).sum(-1)
    nflip_odd = (neg.reshape(B, ng, 8).sum(-1) % 2) == 1
    ax = (w8 * s8 * s8).astype(np.float32)
    imin = ax.argmin(axis=-1)                     # first argmin, C scan
    flip = np.zeros((B, ng, 8), bool)
    bi, gi = np.nonzero(nflip_odd)
    flip[bi, gi, imin[bi, gi]] = True
    xval = np.where(flip.reshape(B, n), -xval, xval).astype(np.float32)
    signs = signs ^ (flip.astype(np.uint16)
                     << np.arange(8)[None, None, :]).sum(-1)
    return xval, (signs & 127).astype(np.uint32)


def _group_weights(xb: np.ndarray, qwb: np.ndarray, group: int):
    """sigma2-weighted importance per element (shared preamble):
    weight = qw * sqrt(sigma2 + x^2), waux = sqrt(weight).
    xb, qwb: (nbl, QK_K).  Returns (weight, waux) reshaped (B, group)."""
    nbl = xb.shape[0]
    sumx2 = _seq_sum((xb * xb).astype(np.float32), QK_K)
    sigma2 = (sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * (QK_K // group)
    gx = xb.reshape(B, group)
    gq = qwb.reshape(B, group)
    gsig = np.repeat(sigma2, QK_K // group)
    weight = (gq * np.sqrt(gsig[:, None] + gx * gx).astype(np.float32)
              ).astype(np.float32)
    return gx, weight, np.sqrt(weight).astype(np.float32)


# --------------------------------------------------------------------------
# IQ2_XXS (quantize_row_iq2_xxs_impl, ggml-quants.c:3294)
# --------------------------------------------------------------------------

def quantize_iq2_xxs(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    """x: (rows, cols) f32, cols % 256 == 0; quant_weights: (cols,) f32.
    Returns packed block_iq2_xxs bytes."""
    t = tables("iq2_xxs")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    assert qw_row.shape == (cols,)

    xb = x.reshape(-1, QK_K)                     # super-blocks
    nbl = xb.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    sumx2 = _seq_sum((xb * xb).astype(np.float32), QK_K)
    sigma2 = (sumx2 / np.float32(QK_K)).astype(np.float32)

    g = xb.reshape(nbl, 8, 32)                   # 32-groups
    qg = qwb.reshape(nbl, 8, 32)
    B = nbl * 8
    gx = g.reshape(B, 32)
    gq = qg.reshape(B, 32)
    gsig = np.repeat(sigma2, 8)

    weight = (gq * np.sqrt(gsig[:, None] + gx * gx).astype(np.float32)
              ).astype(np.float32)
    waux = np.sqrt(weight).astype(np.float32)

    # sign handling per 8-group: fold signs, force even parity by flipping
    # the element with the smallest w*x^2
    xval = np.abs(gx).astype(np.float32)
    neg = gx < 0
    s8 = gx.reshape(B, 4, 8)
    w8 = weight.reshape(B, 4, 8)
    signs = (neg.reshape(B, 4, 8).astype(np.uint16)
             << np.arange(8)[None, None, :]).sum(-1)
    nflip_odd = (neg.reshape(B, 4, 8).sum(-1) % 2) == 1
    ax = (w8 * s8 * s8).astype(np.float32)
    # C scans with strict < starting at i=0 -> first argmin
    imin = ax.argmin(axis=-1)
    flip = np.zeros((B, 4, 8), bool)
    bi, gi = np.nonzero(nflip_odd)
    flip[bi, gi, imin[bi, gi]] = True
    xval = np.where(flip.reshape(B, 32), -xval, xval).astype(np.float32)
    signs = signs ^ (flip.astype(np.uint16)
                     << np.arange(8)[None, None, :]).sum(-1)
    block_signs = (signs & 127).astype(np.uint32)

    mx = xval.max(axis=1)
    live = mx >= GROUP_MAX_EPS

    scale, L = make_qp_quants(xval, weight, 4)  # kMaxQ+1
    eff_max = (scale * np.float32(3)).astype(np.float32)
    live &= eff_max > 0
    L = np.where(live[:, None], L, 0)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)

    best = np.zeros(B, np.float32)
    kMaxQ = 3
    L_best = L.copy()
    safe_eff = np.where(live, eff_max, np.float32(1)).astype(np.float32)
    for is_ in range(-6, 7):
        id_ = ((np.float32(2 * kMaxQ - 1) + np.float32(is_) * np.float32(0.1))
               / safe_eff).astype(np.float32)
        this_scale = (np.float32(1) / id_).astype(np.float32)
        l = nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                           - np.float32(1)))
        Laux = np.clip(l, 0, kMaxQ - 1)
        # group patterns
        u = (Laux.reshape(B, 4, 8)
             << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map = kmap[u]
        offg = gi_map < 0
        if offg.any():
            rows_i, grp_i = np.nonzero(offg & live[:, None])
            if len(rows_i):
                chosen = _find_best_neighbour(
                    "iq2_xxs", u[rows_i, grp_i],
                    xval.reshape(B, 4, 8)[rows_i, grp_i],
                    waux.reshape(B, 4, 8)[rows_i, grp_i],
                    this_scale[rows_i])
                pg = tables("iq2_xxs").grid[chosen]
                Laux = Laux.reshape(B, 4, 8).copy()
                Laux[rows_i, grp_i] = (pg - 1) // 2
                Laux = Laux.reshape(B, 32)
        q = (np.float32(2) * Laux.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        new_scale = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
        scale = np.where(better, new_scale, scale).astype(np.float32)
        best = np.where(better, (new_scale * sumqx).astype(np.float32), best)
        L_best = np.where(better[:, None], Laux, L_best)
    L = L_best

    # final re-fit at the chosen scale
    pos = live & (scale > 0)
    if pos.any():
        id_ = (np.float32(1) / np.where(pos, scale, 1)).astype(np.float32)
        l = np.clip(nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                                   - np.float32(1))),
                    0, kMaxQ - 1)
        u = (l.reshape(B, 4, 8)
             << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map = kmap[u]
        Lr = l.reshape(B, 4, 8).copy()
        on = gi_map >= 0
        pg_on = tables("iq2_xxs").grid[np.where(on, gi_map, 0)]
        rows_i, grp_i = np.nonzero((~on) & pos[:, None])
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq2_xxs", u[rows_i, grp_i],
                xval.reshape(B, 4, 8)[rows_i, grp_i],
                waux.reshape(B, 4, 8)[rows_i, grp_i],
                np.where(pos, scale, 1)[rows_i])
            pg_off = tables("iq2_xxs").grid[chosen]
            Lr[rows_i, grp_i] = (pg_off - 1) // 2
        on_rows, on_grp = np.nonzero(on & pos[:, None])
        Lr[on_rows, on_grp] = (pg_on[on_rows, on_grp] - 1) // 2
        Lfit = Lr.reshape(B, 32)
        q = (np.float32(2) * Lfit.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        refit = pos & (sumq2 > 0)
        scale = np.where(refit,
                         (sumqx / np.where(sumq2 == 0, 1, sumq2)
                          ).astype(np.float32), scale).astype(np.float32)
        L = np.where(pos[:, None], Lfit, L)

    # negative scale: flip signs
    negs = scale < 0
    scale = np.abs(scale).astype(np.float32)
    block_signs = np.where(negs[:, None],
                           (~block_signs.reshape(B, 4)) & 127,
                           block_signs.reshape(B, 4)).astype(np.uint32)

    # final grid indices (must be on-grid now)
    u = (L.reshape(B, 4, 8) << (2 * np.arange(8))[None, None, :]).sum(-1)
    gi_map = kmap[u]
    assert (gi_map[live] >= 0).all(), "off-grid point after quantization"
    gi_map = np.where(live[:, None], gi_map, 0)
    block_signs = np.where(live[:, None], block_signs, 0)

    # pack: per 32-group q2[0] = 4x8-bit grid index, q2[1] = signs|scale<<28
    scales_b = scale.reshape(nbl, 8)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(31)).astype(np.float32)
    d16 = _f16(d)
    # C: id = 1/d with the UNROUNDED d (the f16 store is separate)
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 15).astype(np.uint32)

    q2_lo = (gi_map.astype(np.uint32)
             << (8 * np.arange(4))[None, :]).sum(-1, dtype=np.uint32)
    q2_hi = ((block_signs << (7 * np.arange(4))[None, :])
             .sum(-1, dtype=np.uint32).reshape(nbl, 8)
             | (ls << 28)).astype(np.uint32)
    dead_bl = max_scale == 0
    q2_lo = q2_lo.reshape(nbl, 8)
    q2_lo[dead_bl] = 0
    q2_hi[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 64), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    inter = np.empty((nbl, 16), np.uint32)
    inter[:, 0::2] = q2_lo
    inter[:, 1::2] = q2_hi
    out[:, 2:] = inter.astype("<u4").view(np.uint8).reshape(nbl, 64)
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ2_XS (quantize_row_iq2_xs_impl, ggml-quants.c:3472)
# --------------------------------------------------------------------------

def quantize_iq2_xs(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    """x: (rows, cols) f32, cols % 256 == 0.  Packed block_iq2_xs bytes:
    d (f16) + 32 x u16 (grid index | signs<<9) + 8 scale-nibble bytes."""
    t = tables("iq2_xs")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb = x.reshape(-1, QK_K)
    nbl = xb.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    gx, weight, waux = _group_weights(xb, qwb, 16)   # B = nbl*16, n = 16
    B = gx.shape[0]
    xval, block_signs = _sign_fold(gx, weight)       # signs: (B, 2)

    mx = xval.max(axis=1)
    live = mx >= GROUP_MAX_EPS
    kMaxQ = 3
    safe_mx = np.where(live, mx, np.float32(1)).astype(np.float32)

    L = np.zeros((B, 16), np.int32)
    scale = (safe_mx / np.float32(2 * kMaxQ - 1)).astype(np.float32)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best = np.zeros(B, np.float32)
    on_grid = np.ones((B, 2), bool)
    for is_ in range(-9, 10):
        id_ = ((np.float32(2 * kMaxQ - 1) + np.float32(is_) * np.float32(0.1))
               / safe_mx).astype(np.float32)
        this_scale = (np.float32(1) / id_).astype(np.float32)
        l = nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                           - np.float32(1)))
        Laux = np.clip(l, 0, kMaxQ - 1)
        u = (Laux.reshape(B, 2, 8)
             << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map = kmap[u]
        on_aux = gi_map >= 0
        rows_i, grp_i = np.nonzero((~on_aux) & live[:, None])
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq2_xs", u[rows_i, grp_i],
                xval.reshape(B, 2, 8)[rows_i, grp_i],
                waux.reshape(B, 2, 8)[rows_i, grp_i],
                this_scale[rows_i])
            pg = t.grid[chosen]
            Laux = Laux.reshape(B, 2, 8).copy()
            Laux[rows_i, grp_i] = (pg - 1) // 2
            Laux = Laux.reshape(B, 16)
        q = (np.float32(2) * Laux.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 16)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 16)
        better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        new_scale = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
        scale = np.where(better, new_scale, scale).astype(np.float32)
        best = np.where(better, (new_scale * sumqx).astype(np.float32), best)
        L = np.where(better[:, None], Laux, L)
        on_grid = np.where(better[:, None], on_aux, on_grid)

    # refit only the off-grid groups at the accepted scale
    need = live & (scale > 0) & (~on_grid).any(axis=1)
    if need.any():
        id_ = (np.float32(1) / np.where(need, scale, 1)).astype(np.float32)
        l = np.clip(nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                                   - np.float32(1))),
                    0, kMaxQ - 1)
        Lr = L.reshape(B, 2, 8).copy()
        lr = l.reshape(B, 2, 8)
        sel = need[:, None] & (~on_grid)            # (B, 2) groups to redo
        rows_i, grp_i = np.nonzero(sel)
        Lr[rows_i, grp_i] = lr[rows_i, grp_i]
        u = (lr << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map = kmap[u]
        redo = sel & (gi_map < 0)
        rows_i, grp_i = np.nonzero(redo)
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq2_xs", u[rows_i, grp_i],
                xval.reshape(B, 2, 8)[rows_i, grp_i],
                waux.reshape(B, 2, 8)[rows_i, grp_i],
                np.where(need, scale, 1)[rows_i])
            pg = t.grid[chosen]
            Lr[rows_i, grp_i] = (pg - 1) // 2
        Lfit = Lr.reshape(B, 16)
        q = (np.float32(2) * Lfit.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 16)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 16)
        refit = need & (sumq2 > 0)
        scale = np.where(refit,
                         (sumqx / np.where(sumq2 == 0, 1, sumq2)
                          ).astype(np.float32), scale).astype(np.float32)
        L = np.where(need[:, None], Lfit, L)

    negs = scale < 0
    scale = np.abs(scale).astype(np.float32)
    block_signs = np.where(negs[:, None], (~block_signs) & 127,
                           block_signs).astype(np.uint32)

    u = (L.reshape(B, 2, 8) << (2 * np.arange(8))[None, None, :]).sum(-1)
    gi_map = kmap[u]
    assert (gi_map[live] >= 0).all(), "off-grid point after quantization"
    gi_map = np.where(live[:, None], gi_map, 0)
    block_signs = np.where(live[:, None], block_signs, 0)

    q2 = (gi_map.astype(np.uint32)
          | (block_signs << 9)).astype(np.uint16).reshape(nbl, 32)
    scales_b = scale.reshape(nbl, 16)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(31)).astype(np.float32)
    d16 = _f16(d)
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 15).astype(np.uint8)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)

    dead_bl = max_scale == 0
    q2[dead_bl] = 0
    sc[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 64 + 8), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    out[:, 2:66] = q2.astype("<u2").view(np.uint8).reshape(nbl, 64)
    out[:, 66:] = sc
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ3_XXS (quantize_row_iq3_xxs_impl, ggml-quants.c:3938, grid_size=256)
# --------------------------------------------------------------------------

def quantize_iq3_xxs(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    """Packed block_iq3_xxs bytes: d (f16) + 64 grid-index bytes +
    8 x u32 (signs | scale<<28)."""
    t = tables("iq3_xxs")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb = x.reshape(-1, QK_K)
    nbl = xb.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    # sigma2 = TWO*sumx2/QK_K for iq3 (ggml-quants.c:3997)
    sumx2 = _seq_sum((xb * xb).astype(np.float32), QK_K)
    sigma2 = (np.float32(2) * sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * 8
    gx = xb.reshape(B, 32)
    gq = qwb.reshape(B, 32)
    gsig = np.repeat(sigma2, 8)
    weight = (gq * np.sqrt(gsig[:, None] + gx * gx).astype(np.float32)
              ).astype(np.float32)
    waux = np.sqrt(weight).astype(np.float32)
    xval, block_signs = _sign_fold(gx, weight)       # (B, 32), (B, 4)

    mx = xval.max(axis=1)
    live = mx >= GROUP_MAX_EPS_IQ3_XXS
    kMaxQ = 8
    safe_mx = np.where(live, mx, np.float32(1)).astype(np.float32)

    L = np.zeros((B, 32), np.int32)
    scale = (safe_mx / np.float32(2 * kMaxQ - 1)).astype(np.float32)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best = np.zeros(B, np.float32)
    on_grid = np.ones((B, 8), bool)
    sh3 = (3 * np.arange(4))[None, None, :]
    for is_ in range(-15, 16):
        id_ = ((np.float32(2 * kMaxQ - 1) + np.float32(is_) * np.float32(0.2))
               / safe_mx).astype(np.float32)
        this_scale = (np.float32(1) / id_).astype(np.float32)
        l = nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                           - np.float32(1)))
        Laux = np.clip(l, 0, kMaxQ - 1)
        u = (Laux.reshape(B, 8, 4) << sh3).sum(-1)
        gi_map = kmap[u]
        on_aux = gi_map >= 0
        rows_i, grp_i = np.nonzero((~on_aux) & live[:, None])
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq3_xxs", u[rows_i, grp_i],
                xval.reshape(B, 8, 4)[rows_i, grp_i],
                waux.reshape(B, 8, 4)[rows_i, grp_i],
                this_scale[rows_i])
            pg = t.grid[chosen]
            Laux = Laux.reshape(B, 8, 4).copy()
            Laux[rows_i, grp_i] = (pg - 1) // 2
            Laux = Laux.reshape(B, 32)
        q = (np.float32(2) * Laux.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        new_scale = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
        scale = np.where(better, new_scale, scale).astype(np.float32)
        best = np.where(better, (new_scale * sumqx).astype(np.float32), best)
        L = np.where(better[:, None], Laux, L)
        on_grid = np.where(better[:, None], on_aux, on_grid)

    need = live & (scale > 0) & (~on_grid).any(axis=1)
    if need.any():
        id_ = (np.float32(1) / np.where(need, scale, 1)).astype(np.float32)
        l = np.clip(nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                                   - np.float32(1))),
                    0, kMaxQ - 1)
        Lr = L.reshape(B, 8, 4).copy()
        lr = l.reshape(B, 8, 4)
        sel = need[:, None] & (~on_grid)
        u = (lr << sh3).sum(-1)
        gi_map2 = kmap[u]
        # on-grid redo groups take their fresh l values via the grid row;
        # off-grid ones go through the neighbour search
        rows_i, grp_i = np.nonzero(sel & (gi_map2 >= 0))
        pg_on = t.grid[np.where(gi_map2 >= 0, gi_map2, 0)]
        Lr[rows_i, grp_i] = (pg_on[rows_i, grp_i] - 1) // 2
        rows_i, grp_i = np.nonzero(sel & (gi_map2 < 0))
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq3_xxs", u[rows_i, grp_i],
                xval.reshape(B, 8, 4)[rows_i, grp_i],
                waux.reshape(B, 8, 4)[rows_i, grp_i],
                np.where(need, scale, 1)[rows_i])
            pg = t.grid[chosen]
            Lr[rows_i, grp_i] = (pg - 1) // 2
        Lfit = Lr.reshape(B, 32)
        q = (np.float32(2) * Lfit.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        refit = need & (sumq2 > 0)
        scale = np.where(refit,
                         (sumqx / np.where(sumq2 == 0, 1, sumq2)
                          ).astype(np.float32), scale).astype(np.float32)
        L = np.where(need[:, None], Lfit, L)

    negs = scale < 0
    scale = np.abs(scale).astype(np.float32)
    block_signs = np.where(negs[:, None], (~block_signs) & 127,
                           block_signs).astype(np.uint32)

    u = (L.reshape(B, 8, 4) << sh3).sum(-1)
    gi_map = kmap[u]
    assert (gi_map[live] >= 0).all(), "off-grid point after quantization"
    gi_map = np.where(live[:, None], gi_map, 0)
    block_signs = np.where(live[:, None], block_signs, 0)

    q3 = gi_map.astype(np.uint8).reshape(nbl, 64)
    sns = (block_signs << (7 * np.arange(4))[None, :]
           ).sum(-1, dtype=np.uint32).reshape(nbl, 8)
    scales_b = scale.reshape(nbl, 8)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(31)).astype(np.float32)
    d16 = _f16((d * np.float32(1.0125)).astype(np.float32))  # fudge factor
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 15).astype(np.uint32)
    sns = sns | (ls << 28)

    dead_bl = max_scale == 0
    q3[dead_bl] = 0
    sns[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 64 + 32), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    out[:, 2:66] = q3
    out[:, 66:] = sns.astype("<u4").view(np.uint8).reshape(nbl, 32)
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ3_S (quantize_row_iq3_s_impl, ggml-quants.c:4169, grid_size=512,
# block_size=32) — full 8-bit signs, no parity folding; the final refit
# redoes EVERY 4-group (the reference's is_on_grid skip is commented out)
# --------------------------------------------------------------------------

def quantize_iq3_s(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    t = tables("iq3_s")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb = x.reshape(-1, QK_K)
    nbl = xb.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    sumx2 = _seq_sum((xb * xb).astype(np.float32), QK_K)
    sigma2 = (np.float32(2) * sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * 8
    gx = xb.reshape(B, 32)
    gq = qwb.reshape(B, 32)
    gsig = np.repeat(sigma2, 8)
    weight = (gq * np.sqrt(gsig[:, None] + gx * gx).astype(np.float32)
              ).astype(np.float32)
    waux = np.sqrt(weight).astype(np.float32)

    xval = np.abs(gx).astype(np.float32)
    block_signs = ((gx < 0).reshape(B, 4, 8).astype(np.uint16)
                   << np.arange(8)[None, None, :]).sum(-1).astype(np.uint32)

    mx = xval.max(axis=1)
    live = mx != 0
    kMaxQ = 8
    safe_mx = np.where(live, mx, np.float32(1)).astype(np.float32)

    L = np.zeros((B, 32), np.int32)
    scale = (safe_mx / np.float32(2 * kMaxQ - 1)).astype(np.float32)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best = np.zeros(B, np.float32)
    on_grid = np.zeros((B, 8), bool)     # init FALSE (reference :4246)
    sh3 = (3 * np.arange(4))[None, None, :]
    for is_ in range(-9, 10):
        id_ = ((np.float32(2 * kMaxQ - 1) + np.float32(is_) * np.float32(0.2))
               / safe_mx).astype(np.float32)
        this_scale = (np.float32(1) / id_).astype(np.float32)
        l = nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                           - np.float32(1)))
        Laux = np.clip(l, 0, kMaxQ - 1)
        u = (Laux.reshape(B, 8, 4) << sh3).sum(-1)
        gi_map = kmap[u]
        on_aux = gi_map >= 0
        rows_i, grp_i = np.nonzero((~on_aux) & live[:, None])
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq3_s", u[rows_i, grp_i],
                xval.reshape(B, 8, 4)[rows_i, grp_i],
                waux.reshape(B, 8, 4)[rows_i, grp_i],
                this_scale[rows_i])
            pg = t.grid[chosen]
            Laux = Laux.reshape(B, 8, 4).copy()
            Laux[rows_i, grp_i] = (pg - 1) // 2
            Laux = Laux.reshape(B, 32)
        q = (np.float32(2) * Laux.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        new_scale = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
        scale = np.where(better, new_scale, scale).astype(np.float32)
        best = np.where(better, (new_scale * sumqx).astype(np.float32), best)
        L = np.where(better[:, None], Laux, L)
        on_grid = np.where(better[:, None], on_aux, on_grid)

    need = live & (scale > 0) & (~on_grid).any(axis=1)
    if need.any():
        id_ = (np.float32(1) / np.where(need, scale, 1)).astype(np.float32)
        l = np.clip(nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                                   - np.float32(1))),
                    0, kMaxQ - 1)
        Lr = L.reshape(B, 8, 4).copy()
        lr = l.reshape(B, 8, 4)
        sel = np.broadcast_to(need[:, None], (B, 8))   # ALL groups redo
        u = (lr << sh3).sum(-1)
        gi_map2 = kmap[u]
        rows_i, grp_i = np.nonzero(sel & (gi_map2 >= 0))
        pg_on = t.grid[np.where(gi_map2 >= 0, gi_map2, 0)]
        Lr[rows_i, grp_i] = (pg_on[rows_i, grp_i] - 1) // 2
        rows_i, grp_i = np.nonzero(sel & (gi_map2 < 0))
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq3_s", u[rows_i, grp_i],
                xval.reshape(B, 8, 4)[rows_i, grp_i],
                waux.reshape(B, 8, 4)[rows_i, grp_i],
                np.where(need, scale, 1)[rows_i])
            pg = t.grid[chosen]
            Lr[rows_i, grp_i] = (pg - 1) // 2
        Lfit = Lr.reshape(B, 32)
        q = (np.float32(2) * Lfit.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        refit = need & (sumq2 > 0)
        scale = np.where(refit,
                         (sumqx / np.where(sumq2 == 0, 1, sumq2)
                          ).astype(np.float32), scale).astype(np.float32)
        L = np.where(need[:, None], Lfit, L)

    negs = scale < 0
    scale = np.abs(scale).astype(np.float32)
    block_signs = np.where(negs[:, None], (~block_signs) & 255,
                           block_signs).astype(np.uint32)

    u = (L.reshape(B, 8, 4) << sh3).sum(-1)
    gi_map = kmap[u]
    assert (gi_map[live] >= 0).all(), "off-grid point after quantization"
    gi_map = np.where(live[:, None], gi_map, 0)
    block_signs = np.where(live[:, None], block_signs, 0)

    # qs and signs write COMPACTED over live 32-groups: the reference's
    # dead-group `continue` skips the qs/signs pointer advance
    # (ggml-quants.c:4245,4329-4331) while qh and the scale nibbles keep
    # absolute ib indexing — reproduced exactly.
    qs_g = (gi_map & 255).astype(np.uint8).reshape(nbl, 8, 8)
    hi = (gi_map >> 8).astype(np.uint8).reshape(nbl, 64)
    qh = (hi.reshape(nbl, 8, 8)
          << np.arange(8)[None, None, :]).sum(-1).astype(np.uint8)
    sg_g = block_signs.astype(np.uint8).reshape(nbl, 8, 4)
    live_g = live.reshape(nbl, 8)
    qs = np.zeros((nbl, 64), np.uint8)
    sg = np.zeros((nbl, 32), np.uint8)
    for bl in range(nbl):
        lv = np.nonzero(live_g[bl])[0]
        if len(lv):
            qs[bl, : 8 * len(lv)] = qs_g[bl, lv].reshape(-1)
            sg[bl, : 4 * len(lv)] = sg_g[bl, lv].reshape(-1)

    scales_b = scale.reshape(nbl, 8)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(31)).astype(np.float32)
    d16 = _f16((d * np.float32(1.033)).astype(np.float32))
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 15).astype(np.uint8)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)

    dead_bl = max_scale == 0
    for arr in (qs, qh, sg, sc):
        arr[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 64 + 8 + 32 + 4), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    out[:, 2:66] = qs
    out[:, 66:74] = qh
    out[:, 74:106] = sg
    out[:, 106:] = sc
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ1_S (quantize_row_iq1_s_impl, ggml-quants.c:4508): exhaustive weighted
# 3-way split over value-sorted elements, ternary grid with the IQ1S_DELTA
# shift pair, per-16-ib packing into qs bytes + qh u16s
# --------------------------------------------------------------------------

IQ1S_DELTA = np.float32(0.125)


def _iq1_find_best_neighbour2(u, xb, weight, scale, xx):
    """iq1_find_best_neighbour2 (ggml-quants.c:4442): like the iq2 search
    but grid levels map through the shift table xx and the weights are the
    FULL weights (not waux).  u: (G,) patterns; xb/weight: (G, 8);
    scale: (G,); xx: (G, 3).  Returns grid indices (G,)."""
    t = tables("iq1")
    nl = _neigh("iq1")
    idx, mask = nl.gather(u)
    lv = ((t.grid[idx] - 1) // 2).astype(np.int64)      # (G, C, 8) levels
    q = np.take_along_axis(
        xx[:, None, :].repeat(lv.shape[1], 1).reshape(-1, 3),
        lv.reshape(-1, 8), axis=1).reshape(lv.shape).astype(np.float32)
    diff = (scale[:, None, None] * q - xb[:, None, :]).astype(np.float32)
    terms = (weight[:, None, :] * diff * diff).astype(np.float32)
    d2 = _seq_sum(terms, 8)
    d2 = np.where(mask, d2, np.float32(np.inf))
    best = d2.argmin(axis=1)
    return idx[np.arange(len(u)), best]


def quantize_iq1_s(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    t = tables("iq1")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb_all = x.reshape(-1, QK_K)
    nbl = xb_all.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    bs = 32
    sumx2 = _seq_sum((xb_all * xb_all).astype(np.float32), QK_K)
    sigma2 = (np.float32(2) * sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * (QK_K // bs)
    xb = xb_all.reshape(B, bs)
    gq = qwb.reshape(B, bs)
    gsig = np.repeat(sigma2, QK_K // bs)
    weight = (gq * np.sqrt(gsig[:, None] + xb * xb).astype(np.float32)
              ).astype(np.float32)

    x_p = np.array([-1 + IQ1S_DELTA, IQ1S_DELTA, 1 + IQ1S_DELTA], np.float32)
    x_m = np.array([-1 - IQ1S_DELTA, -IQ1S_DELTA, 1 - IQ1S_DELTA], np.float32)

    mx = np.abs(xb).max(axis=1)
    live = mx >= GROUP_MAX_EPS_IQ1_S

    # sort by value (stable = glibc qsort mergesort with the value-only
    # comparator over index-ascending input)
    order = np.argsort(xb, axis=1, kind="stable")
    xs = np.take_along_axis(xb, order, axis=1)
    ws = np.take_along_axis(weight, order, axis=1)
    sumx = np.zeros((B, bs + 1), np.float32)
    sumw = np.zeros((B, bs + 1), np.float32)
    for j in range(bs):
        sumx[:, j + 1] = (sumx[:, j] + ws[:, j] * xs[:, j]).astype(np.float32)
        sumw[:, j + 1] = (sumw[:, j] + ws[:, j]).astype(np.float32)

    best_score = np.full(B, -np.float32(np.finfo(np.float32).max))
    scale = mx.astype(np.float32).copy()
    besti1 = np.full(B, -1)
    besti2 = np.full(B, -1)
    best_shift = np.zeros(B, np.int32)
    sxT = sumx.T
    swT = sumw.T
    # best_score starts at -FLT_MAX; the C's best*sumq2 product overflows
    # to -inf in f32 on the first comparisons by design
    err = np.errstate(over="ignore", invalid="ignore")
    err.__enter__()
    for i1 in range(bs + 1):
        for i2 in range(i1, bs + 1):
            a1 = sxT[i1]
            a2 = (sxT[i2] - sxT[i1]).astype(np.float32)
            a3 = (sxT[bs] - sxT[i2]).astype(np.float32)
            w1 = swT[i1]
            w2 = (swT[i2] - swT[i1]).astype(np.float32)
            w3 = (swT[bs] - swT[i2]).astype(np.float32)
            for xx, shift in ((x_p, 1), (x_m, -1)):
                sumqx = (a1 * xx[0] + a2 * xx[1] + a3 * xx[2]).astype(np.float32)
                sumq2 = (w1 * (xx[0] * xx[0]) + w2 * (xx[1] * xx[1])
                         + w3 * (xx[2] * xx[2])).astype(np.float32)
                acc = (sumq2 > 0) & ((sumqx * sumqx).astype(np.float32)
                                     > (best_score * sumq2).astype(np.float32))
                ns = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
                scale = np.where(acc, ns, scale).astype(np.float32)
                best_score = np.where(acc, (ns * sumqx).astype(np.float32),
                                      best_score)
                besti1 = np.where(acc, i1, besti1)
                besti2 = np.where(acc, i2, besti2)
                best_shift = np.where(acc, shift, best_shift)
    err.__exit__(None, None, None)

    live &= (besti1 >= 0) & (besti2 >= 0) & (best_shift != 0)

    # L per element via the sorted split
    rankpos = np.empty_like(order)
    np.put_along_axis(rankpos, order, np.arange(bs)[None, :].repeat(B, 0),
                      axis=1)
    L = np.where(rankpos < besti1[:, None], 0,
                 np.where(rankpos < besti2[:, None], 1, 2))
    negs = scale < 0
    L = np.where(negs[:, None], 2 - L, L)
    scale = np.abs(scale).astype(np.float32)
    best_shift = np.where(negs, -best_shift, best_shift)
    L = np.where(live[:, None], L, 1)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best_shift = np.where(live, best_shift, 1)

    xx_tab = np.where((best_shift == 1)[:, None], x_p[None, :], x_m[None, :]
                      ).astype(np.float32)

    u = (L.reshape(B, 4, 8) << (2 * np.arange(8))[None, None, :]).sum(-1)
    gi_map = kmap[u].astype(np.int64)
    all_on = (gi_map >= 0).all(axis=1)
    index = np.where(gi_map >= 0, gi_map, 0)
    rows_i, grp_i = np.nonzero((gi_map < 0) & live[:, None])
    if len(rows_i):
        chosen = _iq1_find_best_neighbour2(
            u[rows_i, grp_i], xb.reshape(B, 4, 8)[rows_i, grp_i],
            weight.reshape(B, 4, 8)[rows_i, grp_i], scale[rows_i],
            xx_tab[rows_i])
        index[rows_i, grp_i] = chosen

    # refit for blocks with any off-grid group
    refit_rows = live & (~all_on)
    if refit_rows.any():
        lv = ((t.grid[index] - 1) // 2).astype(np.int64)     # (B, 4, 8)
        q = np.take_along_axis(xx_tab, lv.reshape(B, -1), axis=1
                               ).reshape(B, 32).astype(np.float32)
        sumqx = _seq_sum((weight * q * xb).astype(np.float32), 32)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 32)
        ok = refit_rows & (sumqx > 0) & (sumq2 > 0)
        scale = np.where(ok, (sumqx / np.where(sumq2 == 0, 1, sumq2)
                              ).astype(np.float32), scale).astype(np.float32)

    index = np.where(live[:, None], index, 0)

    qs = (index & 255).astype(np.uint8).reshape(nbl, 8, 4).reshape(nbl, 32)
    h = ((index >> 8).astype(np.uint16)
         << (3 * np.arange(4))[None, :]).sum(-1).astype(np.uint16)

    scales_b = scale.reshape(nbl, 8)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(15)).astype(np.float32)
    d16 = _f16((d * np.float32(1.125)).astype(np.float32))
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 7).astype(np.uint16)
    ls = ls | np.where(best_shift.reshape(nbl, 8) == -1, 8, 0).astype(np.uint16)
    qh = (h.reshape(nbl, 8) | (ls << 12)).astype(np.uint16)

    dead_bl = max_scale == 0
    qs[dead_bl] = 0
    qh[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 32 + 16), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    out[:, 2:34] = qs
    out[:, 34:] = qh.astype("<u2").view(np.uint8).reshape(nbl, 16)
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ2_S (quantize_row_iq2_s_impl, ggml-quants.c:5142): iq2_xs search shape
# with full 8-bit signs (no parity folding), 1024-entry grid, nwant=1
# --------------------------------------------------------------------------

def quantize_iq2_s(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    t = tables("iq2_s")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb = x.reshape(-1, QK_K)
    nbl = xb.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    sumx2 = _seq_sum((xb * xb).astype(np.float32), QK_K)
    sigma2 = (np.float32(2) * sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * 16
    gx = xb.reshape(B, 16)
    gq = qwb.reshape(B, 16)
    gsig = np.repeat(sigma2, 16)
    weight = (gq * np.sqrt(gsig[:, None] + gx * gx).astype(np.float32)
              ).astype(np.float32)
    waux = np.sqrt(weight).astype(np.float32)

    xval = np.abs(gx).astype(np.float32)
    block_signs = ((gx < 0).reshape(B, 2, 8).astype(np.uint16)
                   << np.arange(8)[None, None, :]).sum(-1).astype(np.uint32)

    mx = xval.max(axis=1)
    live = mx >= GROUP_MAX_EPS_IQ2_S
    kMaxQ = 3
    safe_mx = np.where(live, mx, np.float32(1)).astype(np.float32)

    L = np.zeros((B, 16), np.int32)
    scale = (safe_mx / np.float32(2 * kMaxQ - 1)).astype(np.float32)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best = np.zeros(B, np.float32)
    on_grid = np.ones((B, 2), bool)
    for is_ in range(-9, 10):
        id_ = ((np.float32(2 * kMaxQ - 1) + np.float32(is_) * np.float32(0.1))
               / safe_mx).astype(np.float32)
        this_scale = (np.float32(1) / id_).astype(np.float32)
        l = nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                           - np.float32(1)))
        Laux = np.clip(l, 0, kMaxQ - 1)
        u = (Laux.reshape(B, 2, 8)
             << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map = kmap[u]
        on_aux = gi_map >= 0
        rows_i, grp_i = np.nonzero((~on_aux) & live[:, None])
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq2_s", u[rows_i, grp_i],
                xval.reshape(B, 2, 8)[rows_i, grp_i],
                waux.reshape(B, 2, 8)[rows_i, grp_i],
                this_scale[rows_i])
            pg = t.grid[chosen]
            Laux = Laux.reshape(B, 2, 8).copy()
            Laux[rows_i, grp_i] = (pg - 1) // 2
            Laux = Laux.reshape(B, 16)
        q = (np.float32(2) * Laux.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 16)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 16)
        better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        new_scale = (sumqx / np.where(sumq2 == 0, 1, sumq2)).astype(np.float32)
        scale = np.where(better, new_scale, scale).astype(np.float32)
        best = np.where(better, (new_scale * sumqx).astype(np.float32), best)
        L = np.where(better[:, None], Laux, L)
        on_grid = np.where(better[:, None], on_aux, on_grid)

    need = live & (scale > 0) & (~on_grid).any(axis=1)
    if need.any():
        id_ = (np.float32(1) / np.where(need, scale, 1)).astype(np.float32)
        l = np.clip(nearest_int(np.float32(0.5) * (id_[:, None] * xval
                                                   - np.float32(1))),
                    0, kMaxQ - 1)
        Lr = L.reshape(B, 2, 8).copy()
        lr = l.reshape(B, 2, 8)
        sel = need[:, None] & (~on_grid)
        rows_i, grp_i = np.nonzero(sel)
        Lr[rows_i, grp_i] = lr[rows_i, grp_i]
        u = (lr << (2 * np.arange(8))[None, None, :]).sum(-1)
        gi_map2 = kmap[u]
        redo = sel & (gi_map2 < 0)
        rows_i, grp_i = np.nonzero(redo)
        if len(rows_i):
            chosen = _find_best_neighbour(
                "iq2_s", u[rows_i, grp_i],
                xval.reshape(B, 2, 8)[rows_i, grp_i],
                waux.reshape(B, 2, 8)[rows_i, grp_i],
                np.where(need, scale, 1)[rows_i])
            pg = t.grid[chosen]
            Lr[rows_i, grp_i] = (pg - 1) // 2
        Lfit = Lr.reshape(B, 16)
        q = (np.float32(2) * Lfit.astype(np.float32) + np.float32(1))
        sumqx = _seq_sum((weight * xval * q).astype(np.float32), 16)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 16)
        refit = need & (sumq2 > 0)
        scale = np.where(refit,
                         (sumqx / np.where(sumq2 == 0, 1, sumq2)
                          ).astype(np.float32), scale).astype(np.float32)
        L = np.where(need[:, None], Lfit, L)

    negs = scale < 0
    scale = np.abs(scale).astype(np.float32)
    block_signs = np.where(negs[:, None], (~block_signs) & 255,
                           block_signs).astype(np.uint32)

    u = (L.reshape(B, 2, 8) << (2 * np.arange(8))[None, None, :]).sum(-1)
    gi_map = kmap[u]
    assert (gi_map[live] >= 0).all(), "off-grid point after quantization"
    gi_map = np.where(live[:, None], gi_map, 0)
    block_signs = np.where(live[:, None], block_signs, 0)

    gi_flat = gi_map.reshape(nbl, 32)
    qs_lo = (gi_flat & 255).astype(np.uint8)
    qh = ((gi_flat >> 8).reshape(nbl, 8, 4).astype(np.uint8)
          << (2 * np.arange(4))[None, None, :]).sum(-1).astype(np.uint8)
    sg = block_signs.astype(np.uint8).reshape(nbl, 32)

    scales_b = scale.reshape(nbl, 16)
    max_scale = scales_b.max(axis=1)
    d = (max_scale / np.float32(31)).astype(np.float32)
    d16 = _f16((d * np.float32(0.9875)).astype(np.float32))
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 15).astype(np.uint8)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)

    dead_bl = max_scale == 0
    for arr in (qs_lo, qh, sg, sc):
        arr[dead_bl] = 0
    d16 = np.where(dead_bl, _f16(np.zeros(nbl, np.float32)), d16)

    out = np.empty((nbl, 2 + 32 + 32 + 8 + 8), np.uint8)
    out[:, 0:2] = d16.view(np.uint16).astype("<u2").view(np.uint8).reshape(nbl, 2)
    out[:, 2:34] = qs_lo
    out[:, 34:66] = sg
    out[:, 66:74] = qh
    out[:, 74:] = sc
    return out.tobytes()


# --------------------------------------------------------------------------
# IQ1_M (quantize_row_iq1_m_impl, ggml-quants.c:4692): 16-element blocks,
# 4 shift variants (independent +-delta per 8-half), 3-bit scales packed in
# 4 u16 words whose high nibbles carry the f16 super-scale, and a final
# GLOBAL d refit over the whole super-block
# --------------------------------------------------------------------------

IQ1M_DELTA = np.float32(0.125)


def quantize_iq1_m(x: np.ndarray, quant_weights: np.ndarray) -> bytes:
    t = tables("iq1")
    kmap = t.kmap
    x = np.asarray(x, np.float32)
    rows, cols = x.shape
    qw_row = np.asarray(quant_weights, np.float32)
    xb_all = x.reshape(-1, QK_K)
    nbl = xb_all.shape[0]
    qwb = np.tile(qw_row, rows).reshape(-1, QK_K)

    bs = 16
    sumx2 = _seq_sum((xb_all * xb_all).astype(np.float32), QK_K)
    sigma2 = (np.float32(2) * sumx2 / np.float32(QK_K)).astype(np.float32)
    B = nbl * (QK_K // bs)
    xb = xb_all.reshape(B, bs)
    gq = qwb.reshape(B, bs)
    gsig = np.repeat(sigma2, QK_K // bs)
    weight = (gq * np.sqrt(gsig[:, None] + xb * xb).astype(np.float32)
              ).astype(np.float32)

    x_p = np.array([-1 + IQ1M_DELTA, IQ1M_DELTA, 1 + IQ1M_DELTA], np.float32)
    x_m = np.array([-1 - IQ1M_DELTA, -IQ1M_DELTA, 1 - IQ1M_DELTA], np.float32)
    masks = np.array([0x00, 0x80, 0x08, 0x88], np.uint8)

    mx = np.abs(xb).max(axis=1)
    live = mx >= GROUP_MAX_EPS_IQ1_M

    order = np.argsort(xb, axis=1, kind="stable")
    xs = np.take_along_axis(xb, order, axis=1)
    ws = np.take_along_axis(weight, order, axis=1)
    lo = order < (bs // 2)            # (B, bs): sorted element in first half

    best_score = np.full(B, -np.float32(np.finfo(np.float32).max))
    scale = mx.astype(np.float32).copy()
    besti1 = np.full(B, -1)
    besti2 = np.full(B, -1)
    best_k = np.full(B, -1)

    with np.errstate(over="ignore", invalid="ignore"):
        for i1 in range(bs + 1):
            for i2 in range(i1, bs + 1):
                sq = [np.zeros(B, np.float32) for _ in range(4)]
                s2 = [np.zeros(B, np.float32) for _ in range(4)]
                for j in range(bs):
                    seg = 0 if j < i1 else (1 if j < i2 else 2)
                    w = ws[:, j]
                    xv = xs[:, j]
                    m = lo[:, j]
                    add_p = ((w * x_p[seg]).astype(np.float32)
                             * xv).astype(np.float32)
                    add_m = ((w * x_m[seg]).astype(np.float32)
                             * xv).astype(np.float32)
                    q2_p = ((w * x_p[seg]).astype(np.float32)
                            * x_p[seg]).astype(np.float32)
                    q2_m = ((w * x_m[seg]).astype(np.float32)
                            * x_m[seg]).astype(np.float32)
                    sq[0] = (sq[0] + add_p).astype(np.float32)
                    sq[3] = (sq[3] + add_m).astype(np.float32)
                    sq[1] = (sq[1] + np.where(m, add_p, add_m)).astype(np.float32)
                    sq[2] = (sq[2] + np.where(m, add_m, add_p)).astype(np.float32)
                    s2[0] = (s2[0] + q2_p).astype(np.float32)
                    s2[3] = (s2[3] + q2_m).astype(np.float32)
                    s2[1] = (s2[1] + np.where(m, q2_p, q2_m)).astype(np.float32)
                    s2[2] = (s2[2] + np.where(m, q2_m, q2_p)).astype(np.float32)
                for k in range(4):
                    acc = (s2[k] > 0) & ((sq[k] * sq[k]).astype(np.float32)
                                         > (best_score * s2[k]).astype(np.float32))
                    ns = (sq[k] / np.where(s2[k] == 0, 1, s2[k])
                          ).astype(np.float32)
                    scale = np.where(acc, ns, scale).astype(np.float32)
                    best_score = np.where(acc, (ns * sq[k]).astype(np.float32),
                                          best_score)
                    besti1 = np.where(acc, i1, besti1)
                    besti2 = np.where(acc, i2, besti2)
                    best_k = np.where(acc, k, best_k)

    live &= (besti1 >= 0) & (besti2 >= 0) & (best_k >= 0)

    rankpos = np.empty_like(order)
    np.put_along_axis(rankpos, order, np.arange(bs)[None, :].repeat(B, 0),
                      axis=1)
    L = np.where(rankpos < besti1[:, None], 0,
                 np.where(rankpos < besti2[:, None], 1, 2))
    negs = scale < 0
    L = np.where(negs[:, None], 2 - L, L)
    scale = np.abs(scale).astype(np.float32)
    best_k = np.where(negs, 3 - best_k, best_k)
    L = np.where(live[:, None], L, 1)
    scale = np.where(live, scale, np.float32(0)).astype(np.float32)
    best_k = np.where(live, best_k, 0)

    # per-8-group shift table: group 0 -> best_k < 2, group 1 -> best_k even
    xx0 = np.where((best_k < 2)[:, None], x_p[None, :], x_m[None, :]
                   ).astype(np.float32)
    xx1 = np.where((best_k % 2 == 0)[:, None], x_p[None, :], x_m[None, :]
                   ).astype(np.float32)
    xx_groups = np.stack([xx0, xx1], axis=1)          # (B, 2, 3)

    u = (L.reshape(B, 2, 8) << (2 * np.arange(8))[None, None, :]).sum(-1)
    gi_map = kmap[u].astype(np.int64)
    all_on = (gi_map >= 0).all(axis=1)
    index = np.where(gi_map >= 0, gi_map, 0)
    rows_i, grp_i = np.nonzero((gi_map < 0) & live[:, None])
    if len(rows_i):
        chosen = _iq1_find_best_neighbour2(
            u[rows_i, grp_i], xb.reshape(B, 2, 8)[rows_i, grp_i],
            weight.reshape(B, 2, 8)[rows_i, grp_i], scale[rows_i],
            xx_groups[rows_i, grp_i])
        index[rows_i, grp_i] = chosen

    refit_rows = live & (~all_on)
    if refit_rows.any():
        lv = ((t.grid[index] - 1) // 2).astype(np.int64)     # (B, 2, 8)
        q = np.take_along_axis(
            xx_groups.reshape(B * 2, 3), lv.reshape(B * 2, 8),
            axis=1).reshape(B, 16).astype(np.float32)
        sumqx = _seq_sum((weight * q * xb).astype(np.float32), 16)
        sumq2 = _seq_sum((weight * q * q).astype(np.float32), 16)
        ok = refit_rows & (sumqx > 0) & (sumq2 > 0)
        scale = np.where(ok, (sumqx / np.where(sumq2 == 0, 1, sumq2)
                              ).astype(np.float32), scale).astype(np.float32)

    index = np.where(live[:, None], index, 0)
    qs = (index & 255).astype(np.uint8).reshape(nbl, 32)
    qh = ((index[:, 0] >> 8) | ((index[:, 1] >> 8) << 4)
          ).astype(np.uint8).reshape(nbl, 16)

    scales_b = scale.reshape(nbl, 16)
    shifts_b = best_k.reshape(nbl, 16)
    max_scale = scales_b.max(axis=1)

    d = (max_scale / np.float32(15)).astype(np.float32)
    idd = (np.float32(1) / np.where(d == 0, 1, d)).astype(np.float32)
    ls = np.clip(nearest_int(np.float32(0.5)
                             * (idd[:, None] * scales_b - np.float32(1))),
                 0, 7).astype(np.uint16)
    qh = qh | np.where(max_scale[:, None] > 0,
                       masks[shifts_b], 0).astype(np.uint8)

    # global d refit: q = xx[level] * (2*l+1) over every group, sequential
    # f32 accumulation over the whole super-block (ggml-quants.c:4913-4937)
    lvl = ((t.grid[index] - 1) // 2).astype(np.int64)        # (B, 2, 8)
    qv = np.take_along_axis(
        xx_groups.reshape(B * 2, 3), lvl.reshape(B * 2, 8),
        axis=1).reshape(B, 16).astype(np.float32)
    lfac = (np.float32(2) * ls.reshape(B).astype(np.float32)
            + np.float32(1))
    qq = (qv * lfac[:, None]).astype(np.float32)
    terms_qx = ((weight * qq).astype(np.float32) * xb).astype(np.float32)
    terms_q2 = ((weight * qq).astype(np.float32) * qq).astype(np.float32)
    # accumulate per SUPER-block in C order (ib-major, element order)
    tqx = terms_qx.reshape(nbl, QK_K)
    tq2 = terms_q2.reshape(nbl, QK_K)
    sumqx_f = _seq_sum(tqx, QK_K)
    sumq2_f = _seq_sum(tq2, QK_K)
    d = np.where(sumq2_f > 0,
                 (sumqx_f / np.where(sumq2_f == 0, 1, sumq2_f)
                  ).astype(np.float32), d).astype(np.float32)
    d16 = _f16((d * np.float32(1.1125)).astype(np.float32))

    sc = np.zeros((nbl, 4), np.uint16)
    for ib in range(16):
        sc[:, ib // 4] |= (ls.reshape(nbl, 16)[:, ib]
                           << np.uint16(3 * (ib % 4)))
    u16 = d16.view(np.uint16)
    sc[:, 0] |= ((u16 & 0x000F) << 12)
    sc[:, 1] |= ((u16 & 0x00F0) << 8)
    sc[:, 2] |= ((u16 & 0x0F00) << 4)
    sc[:, 3] |= (u16 & 0xF000)

    dead_bl = max_scale == 0
    qs[dead_bl] = 0
    qh[dead_bl] = 0
    sc[dead_bl] = 0

    out = np.empty((nbl, 32 + 16 + 8), np.uint8)
    out[:, 0:32] = qs
    out[:, 32:48] = qh
    out[:, 48:] = sc.astype("<u2").view(np.uint8).reshape(nbl, 8)
    return out.tobytes()
