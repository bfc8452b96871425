"""Neighborhood kernels: the batched per-center parity form and the
operator form of the sufficient-statistics update.

Counterpart of ``xpysom_dask_tpu/ops/neighborhoods.py``. The parity form
(``gaussian_rect``, ``gaussian_generic``, ``mexican_hat_rect``,
``mexican_hat_generic``, ``bubble``, ``triangle`` and
``prepare_neig_func``) gives ``f(..., c, sigma) -> (N, X, Y)`` for integer
BMU coordinates ``c = (cx, cy)``, as the reference's functions do; it is
what ``XPySom.get_neig_functions`` returns, and training does not use it.
The mexican hat's ``compact_support`` masks each axis in its own box, the
JAX package's documented repair of the reference (PARITY.md).

The operator form (``neighborhood_operator`` and ``apply_operator``)
drives training. For a rectangular grid
every kernel factors as ``H = Σ_k Axᵏ ⊗ Ayᵏ`` with small ``(X, X)`` and
``(Y, Y)`` factors, so the update is four small matmuls per term instead
of a pass over a materialized ``(N, X, Y)`` tensor.

Served here: the rectangular branch (gaussian, mexican_hat, bubble,
triangle, with or without compact support) and the hexagonal branch
(bubble on the integer grid; gaussian and mexican_hat as per-parity-class
separable sums: 3 terms and 9).
"""

from __future__ import annotations

import torch

from .distances import fp32_matmul

__all__ = [
    "prepare_neig_func",
    "gaussian_rect",
    "gaussian_generic",
    "mexican_hat_rect",
    "mexican_hat_generic",
    "bubble",
    "triangle",
    "neighborhood_operator",
    "apply_operator",
]

_F32 = torch.float32


def _box_mask(n, c, sigma):
    """Strict open box ``c - σ < n < c + σ`` as float32."""
    return ((n > c - sigma) & (n < c + sigma)).to(_F32)


def prepare_neig_func(func, *first_args):
    """Partial application helper (reference neighborhoods.py:9-12)."""

    def _inner(*args, **kwargs):
        return func(*first_args, *args, **kwargs)

    return _inner


def _centers(grid, c):
    """The (N, 1) float32 center coordinates ``c`` on ``grid``'s device."""
    return torch.as_tensor(c, device=grid.device).to(_F32)[:, None]


def _generic_centers(xx, yy, c):
    """Euclidean center coordinates ``xx.T[c]``, ``yy.T[c]`` as (N, 1, 1)
    float32 (the meshes have shape (Y, X))."""
    i = torch.as_tensor(c[0], device=xx.device).long()
    j = torch.as_tensor(c[1], device=xx.device).long()
    return xx.T[i, j][:, None, None].to(_F32), yy.T[i, j][:, None, None].to(_F32)


def gaussian_rect(neigx, neigy, std_coeff, compact_support, c, sigma):
    """Gaussian centered at ``c`` on a rectangular grid: separable outer
    product of 1-D gaussians (reference neighborhoods.py:14-33)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx, ny = neigx[None, :].to(_F32), neigy[None, :].to(_F32)
    cx, cy = _centers(neigx, c[0]), _centers(neigy, c[1])
    ax = torch.exp(-torch.square(nx - cx) / d)
    ay = torch.exp(-torch.square(ny - cy) / d)
    if compact_support:
        ax = ax * _box_mask(nx, cx, sigma)
        ay = ay * _box_mask(ny, cy, sigma)
    return ax[:, :, None] * ay[:, None, :]


def gaussian_generic(xx, yy, std_coeff, compact_support, c, sigma):
    """Gaussian centered at ``c`` on any topology via euclidean grid
    coordinates (reference neighborhoods.py:35-55). ``xx``/``yy`` have
    shape ``(Y, X)``; centers gather from the transpose."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx, ny = xx[None, :, :].to(_F32), yy[None, :, :].to(_F32)
    cx, cy = _generic_centers(xx, yy, c)
    ax = torch.exp(-torch.square(nx - cx) / d)
    ay = torch.exp(-torch.square(ny - cy) / d)
    if compact_support:
        ax = ax * _box_mask(nx, cx, sigma)
        ay = ay * _box_mask(ny, cy, sigma)
    return (ax * ay).permute(0, 2, 1)


def mexican_hat_rect(neigx, neigy, std_coeff, compact_support, c, sigma):
    """Mexican hat on a rectangular grid (reference neighborhoods.py:57-74)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx, ny = neigx[None, :].to(_F32), neigy[None, :].to(_F32)
    cx, cy = _centers(neigx, c[0]), _centers(neigy, c[1])
    px = torch.square(nx - cx)
    py = torch.square(ny - cy)
    if compact_support:
        px = px * _box_mask(nx, cx, sigma)
        py = py * _box_mask(ny, cy, sigma)
    p = px[:, :, None] + py[:, None, :]
    return torch.exp(-p / d) * (1.0 - 2.0 / d * p)


def mexican_hat_generic(xx, yy, std_coeff, compact_support, c, sigma):
    """Mexican hat on any topology (reference neighborhoods.py:76-97)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx, ny = xx[None, :, :].to(_F32), yy[None, :, :].to(_F32)
    cx, cy = _generic_centers(xx, yy, c)
    px = torch.square(nx - cx)
    py = torch.square(ny - cy)
    if compact_support:
        px = px * _box_mask(nx, cx, sigma)
        py = py * _box_mask(ny, cy, sigma)
    p = px + py
    return (torch.exp(-p / d) * (1.0 - 2.0 / d * p)).permute(0, 2, 1)


def bubble(neigx, neigy, c, sigma):
    """Constant (boolean box) neighborhood (reference neighborhoods.py:99-112)."""
    nx, ny = neigx[None, :].to(_F32), neigy[None, :].to(_F32)
    cx, cy = _centers(neigx, c[0]), _centers(neigy, c[1])
    return _box_mask(nx, cx, sigma)[:, :, None] * _box_mask(ny, cy, sigma)[:, None, :]


def triangle(neigx, neigy, compact_support, c, sigma):
    """Triangular neighborhood (reference neighborhoods.py:114-130)."""
    nx, ny = neigx[None, :].to(_F32), neigy[None, :].to(_F32)
    cx, cy = _centers(neigx, c[0]), _centers(neigy, c[1])
    tx = torch.clamp(sigma - torch.abs(cx - nx), min=0.0)
    ty = torch.clamp(sigma - torch.abs(cy - ny), min=0.0)
    if compact_support:
        tx = tx * _box_mask(nx, cx, sigma)
        ty = ty * _box_mask(ny, cy, sigma)
    return tx[:, :, None] * ty[:, None, :]


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
    if topology == "hexagonal" and name != "bubble":
        return _hexagonal_operator(name, neigx, neigy, std_coeff, compact_support, sigma)
    # bubble stays on the integer grid under hex topology, as in the
    # reference: the rectangular factors
    if topology not in ("rectangular", "hexagonal"):
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


def _hexagonal_operator(name, neigx, neigy, std_coeff, compact_support, sigma):
    """The hexagonal branch of gaussian and mexican hat. The hex offset (``grid_coordinates``) shifts
    the x coordinate of alternate rows by 0.5, so for center (a, b) and
    node (i, j): ``Δx = (i − a) − 0.5·(off(j) − off(b))``, ``Δy = j − b``,
    with ``off(r) ∈ {0, 1}`` marking the shifted rows. ``δ = off(j) −
    off(b)`` takes three values, each fixed by the two rows' parity
    classes, so the generic kernels factor exactly into
    ``Σ_δ AXδ ⊗ (Ay ⊙ Mδ)``: three class-masked separable terms for
    gaussian, nine for mexican hat."""
    if name not in ("gaussian", "mexican_hat"):
        raise ValueError(f"{name!r} neighborhood not available for hexagonal topology")
    d = 2.0 * std_coeff**2 * sigma**2
    y_dim = int(neigy.shape[0])
    # off[r] = 1 where grid_coordinates' xx[::-2] shifted row r: rows
    # counted from the END, i.e. (Y − 1 − r) even
    # built on the device: a copy from pageable host memory here would wait
    # for the stream, after the statistics, once per member and epoch
    off = ((y_dim - 1 - torch.arange(y_dim, device=neigy.device)) % 2 == 0).to(_F32)
    m_same = off[:, None] * off[None, :] + (1.0 - off[:, None]) * (1.0 - off[None, :])
    m_p = (1.0 - off[:, None]) * off[None, :]  # center class 0 → node 1
    m_m = off[:, None] * (1.0 - off[None, :])  # center class 1 → node 0
    masks = (m_same, m_p, m_m)

    ii = neigx[None, :].to(_F32)  # node x-index i
    aa = neigx[:, None].to(_F32)  # center x-index a
    dxs = (ii - aa, ii - aa - 0.5, ii - aa + 0.5)  # δ ∈ {0, +1, −1}
    dy = neigy[None, :].to(_F32) - neigy[:, None].to(_F32)

    def box(dv):
        return ((dv > -sigma) & (dv < sigma)).to(_F32)

    if name == "gaussian":
        ay = torch.exp(-torch.square(dy) / d)
        if compact_support:
            ay = ay * box(dy)
        terms = []
        for dx, mask in zip(dxs, masks):
            ax = torch.exp(-torch.square(dx) / d)
            if compact_support:
                ax = ax * box(dx)
            terms.append((ax, ay * mask))
        return ("sum_separable", terms)

    # mexican hat: H = e^{−p/d}(1 − 2p/d) = Ex⊗Ey − (Ex·u)⊗Ey − Ex⊗(Ey·v)
    # per class, with p = px + py (each axis masked like the generic form)
    py = torch.square(dy)
    if compact_support:
        py = py * box(dy)
    ey = torch.exp(-py / d)
    v = 2.0 / d * py
    terms = []
    for dx, mask in zip(dxs, masks):
        px = torch.square(dx)
        if compact_support:
            px = px * box(dx)
        ex = torch.exp(-px / d)
        u = 2.0 / d * px
        terms.extend([(ex, ey * mask), (-ex * u, ey * mask), (ex, -(ey * v) * mask)])
    return ("sum_separable", terms)


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
