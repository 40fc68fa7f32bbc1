"""Multi-scale deformable attention sampling core (MSDA).

Counterpart of ``distillbev_tpu/ops/ms_deform_attn.py``: bilinear
sampling of ``value`` at ``sampling_locations`` on every level, weighted
by ``attention_weights`` and summed over levels and points, with zero
outside each level (mmcv's ``ms_deform_attn``).  One
``torch.autograd.Function`` saves only its inputs and recomputes every
sample in the backward, as the JAX custom VJP does.

Levels take the JAX package's two routes (``_is_dense``):

* gather levels sample a SUPERCELL table: row ``(y0, x0)`` of a level's
  zero-bordered grid holds its whole 2x2 bilinear window ``[v00, v01,
  v10, v11]`` as one 4C-wide row, so one sample is one row.  Their
  dvalue goes through ``scatter_add_rows_expand`` (the hand-written
  Hopper kernel of ``csrc/scatter_rows_expand.cu``; its plain version on
  the CPU) into one supercell accumulator per (batch, head) group
  holding every gather level, one launch per backward call, and is
  folded back onto the grid;
* dense levels, ``(h + 2)(w + 2) <= _DENSE_MAX_CELLS``, fold the
  separable lerp weights into one ``[Q, cells]`` matrix per group: the
  forward is a matmul with the padded grid, the dvalue its transpose.

dloc and dwgt come from the four corner dot products ``<dout, v_k>``.
Queries go in chunks so that no ``[rows, 4C]`` temporary exceeds
``_MAX_ROWS`` rows (512 MB at 4C = 128).  Samples whose window lies
wholly outside a level have four zero corner weights; the dvalue scatter
drops them, which leaves every sum unchanged.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .scatter_rows import scatter_add_rows_expand

_DENSE_MAX_CELLS = 512
_MAX_ROWS = 1 << 20

Shapes = Tuple[Tuple[int, int], ...]


def _is_dense(h: int, w: int) -> bool:
    return (h + 2) * (w + 2) <= _DENSE_MAX_CELLS


def _level_groups(shapes: Shapes) -> Tuple[List[int], List[int]]:
    gather = [i for i, (h, w) in enumerate(shapes) if not _is_dense(h, w)]
    dense = [i for i, (h, w) in enumerate(shapes) if _is_dense(h, w)]
    return gather, dense


def _level_split(value: torch.Tensor, shapes: Shapes):
    return torch.split(value, [h * w for h, w in shapes], dim=1)


def _to_groups(a: torch.Tensor) -> torch.Tensor:
    """``[B, Q, M, ...]`` -> ``[B*M, Q, ...]`` (b-major groups)."""
    a = a.movedim(2, 1)
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def _from_groups(a: torch.Tensor, b: int, m: int) -> torch.Tensor:
    """``[B*M, Q, ...]`` -> ``[B, Q, M, ...]``."""
    return a.reshape((b, m) + a.shape[1:]).movedim(1, 2)


def _padded_grid(value_l: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, h*w, M, C]`` -> ``[B*M, h+2, w+2, C]`` zero-bordered grid."""
    b, _, m, c = value_l.shape
    v = value_l.reshape(b, h, w, m, c).permute(0, 3, 1, 2, 4)
    return F.pad(v.reshape(b * m, h, w, c), (0, 0, 1, 1, 1, 1))


def _supercell_table(value: torch.Tensor, shapes: Shapes,
                     levels: Sequence[int]):
    """``[B*M, cells, 4C]`` supercell table of ``levels`` (concatenated)
    and each level's first row."""
    per_level = _level_split(value, shapes)
    tabs, bases, cells = [], [], 0
    for i in levels:
        h, w = shapes[i]
        pv = _padded_grid(per_level[i], h, w)
        sc = torch.cat([pv[:, :-1, :-1], pv[:, :-1, 1:], pv[:, 1:, :-1],
                        pv[:, 1:, 1:]], dim=-1)
        tabs.append(sc.reshape(sc.shape[0], (h + 1) * (w + 1), -1))
        bases.append(cells)
        cells += (h + 1) * (w + 1)
    return torch.cat(tabs, dim=1), bases, cells


def _window(loc: torch.Tensor, hs: Sequence[int], ws: Sequence[int]):
    """``loc [..., L, P, 2]`` normalised (x, y) -> window origins
    ``y0i, x0i`` (int64, zero-bordered grid coordinates, clipped), corner
    lerp weights ``w4 [..., L, P, 4]`` (y-major corners, zero for a
    sample wholly outside its level) and ``(lx, ly, ok)``."""
    dev = loc.device
    hv = torch.tensor(hs, dtype=torch.float32, device=dev).reshape(-1, 1)
    wv = torch.tensor(ws, dtype=torch.float32, device=dev).reshape(-1, 1)
    x = loc[..., 0] * wv - 0.5
    y = loc[..., 1] * hv - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    ok = (x0 >= -1) & (x0 <= wv - 1) & (y0 >= -1) & (y0 <= hv - 1)
    x0i = torch.minimum(x0.clamp(min=-1), wv - 1).long() + 1
    y0i = torch.minimum(y0.clamp(min=-1), hv - 1).long() + 1
    zero = torch.zeros_like(lx)
    w4 = torch.stack([
        torch.where(ok, (1 - lx) * (1 - ly), zero),
        torch.where(ok, lx * (1 - ly), zero),
        torch.where(ok, (1 - lx) * ly, zero),
        torch.where(ok, lx * ly, zero)], dim=-1)
    return y0i, x0i, w4, (lx, ly, ok)


def _axis_weights(t: torch.Tensor, n: int) -> torch.Tensor:
    """Lerp weights of coordinates ``t [...]`` over the ``n + 2`` cells of
    one zero-bordered axis -> ``[..., n + 2]``."""
    t0 = torch.floor(t)
    frac = t - t0
    ok = (t0 >= -1) & (t0 <= n - 1)
    t0i = t0.clamp(-1, n - 1).long() + 1
    zero = torch.zeros_like(frac)
    idx = torch.arange(n + 2, device=t.device)
    lo = torch.where(ok, 1 - frac, zero)[..., None]
    hi = torch.where(ok, frac, zero)[..., None]
    z = lo.new_zeros(())
    return (torch.where(idx == t0i[..., None], lo, z) +
            torch.where(idx == t0i[..., None] + 1, hi, z))


def _dense_lhs(loc: torch.Tensor, wgt: torch.Tensor, h: int,
               w: int) -> torch.Tensor:
    """``loc [G, q, P, 2]``, ``wgt [G, q, P]`` -> ``[G, q, (h+2)(w+2)]``:
    per query the sum over points of the weighted outer products of the
    two axes' lerp weights."""
    wx = _axis_weights(loc[..., 0] * w - 0.5, w)
    wy = _axis_weights(loc[..., 1] * h - 0.5, h) * wgt[..., None]
    lhs = torch.einsum("gqpy,gqpx->gqyx", wy, wx)
    return lhs.reshape(lhs.shape[0], lhs.shape[1], -1)


def _chunk(q: int, groups: int, rows_per_query: int) -> int:
    return max(1, min(q, _MAX_ROWS // max(1, groups * rows_per_query)))


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the per-group ``table [G, cells, W]`` at ``ids [G, ...]``
    -> ``[G, n, W]``."""
    g, cells, width = table.shape
    flat = ids.reshape(g, -1) + cells * torch.arange(
        g, device=ids.device)[:, None]
    return table.reshape(-1, width).index_select(0, flat.reshape(-1)
                                                 ).reshape(g, -1, width)


def expand_operands(loc_g: torch.Tensor, wgt_g: torch.Tensor,
                    shapes: Shapes, levels: Sequence[int]):
    """Operands of ``scatter_add_rows_expand`` for the dvalue of the
    gather ``levels``: ``ids_sq [G, Lg*P, Q]`` int32 sample-major rows of
    the supercell accumulator (samples wholly outside their level
    dropped), ``w [G, Q, 4 Lg P]`` corner weight x attention weight, and
    the accumulator's size.  ``loc_g [G, Q, L, P, 2]``, ``wgt_g [G, Q, L,
    P]``."""
    hs = [shapes[i][0] for i in levels]
    ws = [shapes[i][1] for i in levels]
    y0i, x0i, w4, (_, _, ok) = _window(loc_g[:, :, levels], hs, ws)
    bases, size = [], 0
    for h, w in zip(hs, ws):
        bases.append(size)
        size += (h + 1) * (w + 1)
    dev = loc_g.device
    base = torch.tensor(bases, device=dev).reshape(-1, 1)
    stride = torch.tensor([w + 1 for w in ws], device=dev).reshape(-1, 1)
    ids = torch.where(ok, base + y0i * stride + x0i,
                      torch.full_like(y0i, size))
    g, q = ids.shape[:2]
    ids_sq = ids.reshape(g, q, -1).transpose(1, 2).to(torch.int32)
    wq = (w4 * wgt_g[:, :, levels, :, None]).reshape(g, q, -1)
    return ids_sq.contiguous(), wq.contiguous(), size


def _fold_supercell(acc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[G, (h+1)(w+1), 4C]`` supercell grads -> ``[G, h, w, C]``: corner
    ``(j, i)`` of supercell ``(y0, x0)`` is padded cell ``(y0+j, x0+i)``,
    the core cells are ``[1, h] x [1, w]``."""
    g = acc.shape[0]
    a = acc.reshape(g, h + 1, w + 1, 4, -1)
    return (a[:, 1:h + 1, 1:w + 1, 0] + a[:, 1:h + 1, 0:w, 1] +
            a[:, 0:h, 1:w + 1, 2] + a[:, 0:h, 0:w, 3])


def _forward(value, shapes: Shapes, loc, weight):
    b, _, m, c = value.shape
    q, p = loc.shape[1], loc.shape[4]
    groups = b * m
    gather, dense = _level_groups(shapes)
    loc_g = _to_groups(loc)
    wgt_g = _to_groups(weight)
    out = value.new_zeros(groups, q, c)
    if gather:
        table, bases, _ = _supercell_table(value, shapes, gather)
        hs = [shapes[i][0] for i in gather]
        ws = [shapes[i][1] for i in gather]
        base = torch.tensor(bases, device=value.device).reshape(-1, 1)
        stride = torch.tensor([w + 1 for w in ws],
                              device=value.device).reshape(-1, 1)
    per_level = _level_split(value, shapes)
    grids = {i: _padded_grid(per_level[i], *shapes[i]).reshape(
        groups, -1, c) for i in dense}
    qc = _chunk(q, groups, max(1, len(gather)) * p)
    for q0 in range(0, q, qc):
        sl = slice(q0, q0 + qc)
        n = min(q, q0 + qc) - q0
        if gather:
            y0i, x0i, w4, _ = _window(loc_g[:, sl][:, :, gather], hs, ws)
            rows = _take(table, base + y0i * stride + x0i)
            wf = w4 * wgt_g[:, sl][:, :, gather, :, None]
            out[:, sl] += torch.matmul(
                wf.reshape(groups, n, 1, -1),
                rows.reshape(groups, n, -1, c)).squeeze(2)
        for i in dense:
            lhs = _dense_lhs(loc_g[:, sl, i], wgt_g[:, sl, i], *shapes[i])
            out[:, sl] += torch.bmm(lhs, grids[i])
    return _from_groups(out, b, m).reshape(b, q, m * c)


def _backward(value, shapes: Shapes, loc, weight, grad_out):
    b, _, m, c = value.shape
    q, num_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    groups = b * m
    gather, dense = _level_groups(shapes)
    loc_g = _to_groups(loc)
    wgt_g = _to_groups(weight)
    g = _to_groups(grad_out.reshape(b, q, m, c)).contiguous()
    hs = [h for h, _ in shapes]
    ws = [w for _, w in shapes]
    dev = value.device
    hv = torch.tensor(hs, dtype=torch.float32, device=dev).reshape(-1, 1)
    wv = torch.tensor(ws, dtype=torch.float32, device=dev).reshape(-1, 1)
    # the dloc/dwgt corner dot products need the windows of every level
    table, bases, _ = _supercell_table(value, shapes, range(num_levels))
    base = torch.tensor(bases, device=dev).reshape(-1, 1)
    stride = torch.tensor([w + 1 for w in ws], device=dev).reshape(-1, 1)
    dloc = loc.new_empty(groups, q, num_levels, p, 2)
    dwgt = weight.new_empty(groups, q, num_levels, p)
    dvd = {i: value.new_zeros(groups, (shapes[i][0] + 2) *
                              (shapes[i][1] + 2), c) for i in dense}
    qc = _chunk(q, groups, num_levels * p)
    for q0 in range(0, q, qc):
        sl = slice(q0, q0 + qc)
        n = min(q, q0 + qc) - q0
        y0i, x0i, w4, (lx, ly, ok) = _window(loc_g[:, sl], hs, ws)
        rows = _take(table, base + y0i * stride + x0i)
        gdot = torch.matmul(rows.reshape(groups, n, -1, c),
                            g[:, sl, :, None]).reshape(
            groups, n, num_levels, p, 4)
        dwgt[:, sl] = (w4 * gdot).sum(-1)
        g00, g01, g10, g11 = gdot.unbind(-1)
        wgt_f = wgt_g[:, sl] * ok.to(gdot.dtype)
        dx = (-(1 - ly) * g00 + (1 - ly) * g01 - ly * g10 + ly * g11) \
            * wgt_f * wv
        dy = (-(1 - lx) * g00 - lx * g01 + (1 - lx) * g10 + lx * g11) \
            * wgt_f * hv
        dloc[:, sl] = torch.stack([dx, dy], dim=-1)
        for i in dense:
            lhs = _dense_lhs(loc_g[:, sl, i], wgt_g[:, sl, i], *shapes[i])
            dvd[i] += torch.bmm(lhs.transpose(1, 2), g[:, sl])
    del table

    parts = [None] * num_levels
    if gather:
        ids_sq, wq, size = expand_operands(loc_g, wgt_g, shapes, gather)
        acc = scatter_add_rows_expand(ids_sq, wq, g, size)
        start = 0
        for i in gather:
            h, w = shapes[i]
            cells = (h + 1) * (w + 1)
            parts[i] = _fold_supercell(acc[:, start:start + cells], h, w)
            start += cells
    for i in dense:
        h, w = shapes[i]
        parts[i] = dvd[i].reshape(groups, h + 2, w + 2, c)[
            :, 1:h + 1, 1:w + 1]
    dval = torch.cat([part.reshape(b, m, -1, c) for part in parts], dim=2)
    return (dval.permute(0, 2, 1, 3).contiguous(),
            _from_groups(dloc, b, m), _from_groups(dwgt, b, m))


class _MSDeformAttn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, value, loc, weight, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, weight)
        return _forward(value, shapes, loc, weight)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, weight = ctx.saved_tensors
        dval, dloc, dwgt = _backward(value, ctx.shapes, loc, weight,
                                     grad_out.contiguous())
        return dval, dloc, dwgt, None


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention.

    Args:
        value: ``[B, sum(H_l*W_l), M, C]`` multi-level flattened features.
        spatial_shapes: ``((H_0, W_0), ...)`` per level.
        sampling_locations: ``[B, Q, M, L, P, 2]`` normalised (x, y).
        attention_weights: ``[B, Q, M, L, P]`` (softmax-normalised by
            the caller).

    Returns ``[B, Q, M*C]``.
    """
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if sampling_locations.shape[3] != len(shapes):
        raise ValueError(f"{sampling_locations.shape[3]} levels in the "
                         f"locations, {len(shapes)} spatial shapes")
    return _MSDeformAttn.apply(value.contiguous(),
                               sampling_locations.contiguous(),
                               attention_weights.contiguous(), shapes)
