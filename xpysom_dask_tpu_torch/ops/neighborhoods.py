"""Neighborhood operator for the sufficient-statistics update.

Counterpart of the operator form in ``xpysom_dask_tpu/ops/neighborhoods.py``
(``neighborhood_operator`` and ``apply_operator``). For a rectangular grid
every kernel factors as ``H = Σ_k Axᵏ ⊗ Ayᵏ`` with small ``(X, X)`` and
``(Y, Y)`` factors, so the update is four small matmuls per term instead
of a pass over a materialized ``(N, X, Y)`` tensor.

Served here: the rectangular branch (gaussian, mexican_hat, bubble,
triangle, with or without compact support). The hexagonal per-parity-
class operator is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import torch

from .distances import fp32_matmul

__all__ = ["neighborhood_operator", "apply_operator"]

_F32 = torch.float32


def _box_mask(n, c, sigma):
    """Strict open box ``c - σ < n < c + σ`` as float32."""
    return ((n > c - sigma) & (n < c + sigma)).to(_F32)


def _axis_factors_gaussian(n1d, std_coeff, compact_support, sigma):
    """(K, K) matrix A[c, i] = exp(-(i-c)²/d) [· box mask] along one axis."""
    d = 2.0 * std_coeff**2 * sigma**2
    n = n1d[None, :].to(_F32)
    c = n1d[:, None].to(_F32)
    a = torch.exp(-torch.square(n - c) / d)
    if compact_support:
        a = a * _box_mask(n, c, sigma)
    return a


def neighborhood_operator(
    name, topology, neigx, neigy, std_coeff, compact_support, sigma
):
    """Return ``("sum_separable", [(Ax, Ay), ...])`` — the per-epoch
    operator ``H = Σ_k Axᵏ ⊗ Ayᵏ`` with ``num[j] = Σ_b H[b, j]·S[b]``.

    ``neigx``/``neigy`` are float32 grid index vectors; ``sigma`` is a
    float32 scalar tensor (or float)."""
    if topology == "hexagonal":
        raise NotImplementedError(
            "the hexagonal neighborhood operator is not ported yet "
            "(ROADMAP Queue 1 item 6)"
        )
    if topology != "rectangular":
        raise ValueError(f"unknown topology {topology!r}")
    nx = neigx[None, :].to(_F32)
    cx = neigx[:, None].to(_F32)
    ny = neigy[None, :].to(_F32)
    cy = neigy[:, None].to(_F32)
    if name == "gaussian":
        ax = _axis_factors_gaussian(neigx, std_coeff, compact_support, sigma)
        ay = _axis_factors_gaussian(neigy, std_coeff, compact_support, sigma)
        return ("sum_separable", [(ax, ay)])
    if name == "bubble":
        return ("sum_separable", [(_box_mask(nx, cx, sigma), _box_mask(ny, cy, sigma))])
    if name == "triangle":
        ax = torch.clamp(sigma - torch.abs(cx - nx), min=0.0)
        ay = torch.clamp(sigma - torch.abs(cy - ny), min=0.0)
        if compact_support:
            ax = ax * _box_mask(nx, cx, sigma)
            ay = ay * _box_mask(ny, cy, sigma)
        return ("sum_separable", [(ax, ay)])
    if name == "mexican_hat":
        # H = Ex⊗Ey · (1 - u - v) with u = 2px/d, v = 2py/d
        #   = Ex⊗Ey - (Ex·u)⊗Ey - Ex⊗(Ey·v): a rank-3 separable sum.
        d = 2.0 * std_coeff**2 * sigma**2
        px = torch.square(nx - cx)
        py = torch.square(ny - cy)
        if compact_support:
            px = px * _box_mask(nx, cx, sigma)
            py = py * _box_mask(ny, cy, sigma)
        ex = torch.exp(-px / d)
        ey = torch.exp(-py / d)
        u = 2.0 / d * px
        v = 2.0 / d * py
        return ("sum_separable", [(ex, ey), (-ex * u, ey), (ex, -ey * v)])
    raise ValueError(f"unknown neighborhood {name!r}")


def apply_operator(op, s_flat, cnt):
    """Apply a neighborhood operator to per-BMU sufficient statistics.

    ``s_flat``: (XY, D) summed samples per BMU; ``cnt``: (XY,) counts.
    Returns ``(num_flat, den_flat)``: ``num[j] = Σ_b H[b, j] S[b]`` and
    ``den[j] = Σ_b H[b, j] cnt[b]``, in full fp32."""
    kind, payload = op
    if kind != "sum_separable":
        raise ValueError(f"unknown operator kind {kind!r}")
    xy, d_dim = s_flat.shape
    x_dim = payload[0][0].shape[0]
    y_dim = payload[0][1].shape[0]
    s3 = s_flat.reshape(x_dim, y_dim, d_dim)
    c2 = cnt.reshape(x_dim, y_dim)
    num = torch.zeros_like(s3)
    den = torch.zeros_like(c2)
    with fp32_matmul():
        for ax, ay in payload:
            # num[i,j,d] += Σ_{a,b} Ax[a,i]·Ay[b,j]·S[a,b,d]
            t = torch.einsum("ai,abd->ibd", ax, s3)
            num = num + torch.einsum("bj,ibd->ijd", ay, t)
            tc = torch.einsum("ai,ab->ib", ax, c2)
            den = den + torch.einsum("bj,ib->ij", ay, tc)
    return num.reshape(xy, d_dim), den.reshape(xy)
