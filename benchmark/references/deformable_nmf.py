"""Plain reference of deformable NMF's alternation, for the benchmark's check.

What ``DeformableNMF.fit`` computes, written from the model's equations in
plain PyTorch, frame by frame.  It imports nothing of the measured package
and takes nothing that package made: the recording, the anchors and the
starting warps are the benchmark's own, and the starting traces are drawn
here by the fit's documented rule (uniform, CPU generator seeded with the
optimizer's seed).

The model.  A voxel ``x`` of frame ``t`` sits at the deformed coordinate
``psi_t(x) = denorm(phi(norm(x)) @ beta_t)``, ``phi`` the quadratic basis
``[1, x, y, z, x^2, y^2, z^2, xy, xz, yz]`` on ``[-1, 1]^3``.  Neuron ``k``
has the footprint ``A_tk(x) = exp(-|psi_t(x) - p_k|^2 / s^2) * w(psi_t(x))``
with the border fade ``w`` (1 inside, a linear ramp to 0 across the last
voxel outside).  Per frame the motion loss is ``sum_x (sum_k c_kt A_tk(x)
- y_t(x))^2 / P + gamma * reg_t``, ``reg_t`` the squared log-determinants
of the warp's Jacobian at the two corners ``(-1, -1, -1)``, ``(1, 1, 1)``;
its gradient comes from autograd, and one Adam step (optax's, all frames
at once) follows each epoch.  Then per frame the Gram ``G_t = A_t^T A_t``
and ``c1_t = A_t^T y_t``, and ``mu_iters`` multiplicative updates ``c_t <-
c_t * c1_t / (G_t c_t + 1e-32)``.  With ``gram_mode`` ``"auto"`` the Gram
is the closed form (:func:`closed_form_grams`) once the audit has compared
it with the exact Gram at the strongest-warped frame, within the trust
tolerance; past it the exact Gram.

Frames are independent given the anchors (no temporal smoothing of the
traces), so :func:`follow` runs the schedule on any subset of frames, and
:func:`follow_refine` the refinement after it: per-frame positions
``pos_t [F, K, 3]`` in the model's frame take the anchors' place in the
footprints, ``A_tk(x) = exp(-|psi_t(x) - pos_tk|^2 / s^2) * w(psi_t(x))``,
fitted by Adam against the reconstruction with a tether to the anchors,
and the Grams and ``c1`` are taken at them.  A
footprint is evaluated only on the voxels of a box around its anchor that
holds every voxel where ``|psi - p| < 5 s``: past it a footprint is under
``exp(-25) ~ 1.4e-11`` of its peak, three orders of magnitude below
float32's resolution.  The warp moves a voxel by at most ``D_d = hi_d / 2
* sum_j |beta_jd - I_jd|`` along axis ``d``, so the box's half-width is
``5 s + D_d``, and, with per-frame positions, that plus the positions'
largest distance from their anchors along the axis.

``precision="tf32"`` rounds the operands of every matrix product to
TF32's 10 mantissa bits (the control of the benchmark's check); float32
otherwise, with TF32 switched off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

REACH_SIGMAS = 5.0
EPS = 1e-32


def set_strict_float32() -> None:
    """Float32 products without TF32, on the card as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, ties away); the
    gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


class Plain:
    """Matrix products in float32, or with TF32-rounded operands."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)


# ----------------------------------------------------------------------
# Geometry
# ----------------------------------------------------------------------
def norm_hi(size, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([max(float(s) - 1.0, 1.0) for s in size],
                        dtype=like.dtype, device=like.device)


def basis(u: torch.Tensor) -> torch.Tensor:
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                        x * y, x * z, y * z], dim=-1)


def identity(n: int, device=None) -> torch.Tensor:
    b = torch.zeros((n, 10, 3), dtype=torch.float32, device=device)
    b[:, 1, 0] = b[:, 2, 1] = b[:, 3, 2] = 1.0
    return b


def fade(psi: torch.Tensor, size) -> torch.Tensor:
    """Border fade of deformed coordinates ``psi [..., 3]``: ``[...]``."""
    top = torch.tensor([float(s) - 1.0 for s in size], dtype=psi.dtype,
                       device=psi.device)
    inside = torch.minimum(psi, top - psi)
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
    one = torch.ones((), dtype=psi.dtype, device=psi.device)
    w = torch.minimum(torch.maximum(1.0 + inside, zero), one)
    return w[..., 0] * w[..., 1] * w[..., 2]


def reach(betas: torch.Tensor, size, sigma: float,
          excursion: Optional[torch.Tensor] = None) -> tuple:
    """Per-axis box half-widths that hold every voxel within ``5 sigma``
    of an anchor after any of the warps ``betas [B, 10, 3]``; of a
    position within ``excursion [3]`` (per axis) of its anchor, if given."""
    dev = (betas - identity(1, betas.device)).abs().sum(dim=1).amax(dim=0)
    shift = 0.5 * norm_hi(size, betas) * dev
    if excursion is not None:
        shift = shift + excursion
    return tuple(int(math.ceil(REACH_SIGMAS * sigma + float(d) + 0.5))
                 for d in shift)


class Boxes:
    """Each neuron's box of voxels: a window of ``2 h + 1`` voxels per
    axis around the rounded anchor, shifted to lie inside the volume (the
    whole axis where it is shorter).  ``flat [K, nb]`` voxel indices,
    ``phi [K, nb, 10]`` their basis rows."""

    def __init__(self, pos: torch.Tensor, size, half):
        dev = pos.device
        axes = []
        for d in range(3):
            s, n = int(size[d]), min(2 * int(half[d]) + 1, int(size[d]))
            start = torch.clamp(torch.round(pos[:, d]) - half[d], 0, s - n)
            axes.append(start[:, None] + torch.arange(n, device=dev))
        gx, gy, gz = (a.shape[1] for a in axes)
        vox = torch.stack([
            axes[0][:, :, None, None].expand(-1, gx, gy, gz),
            axes[1][:, None, :, None].expand(-1, gx, gy, gz),
            axes[2][:, None, None, :].expand(-1, gx, gy, gz)],
            dim=-1).reshape(pos.shape[0], -1, 3)
        m, n, z = (int(s) for s in size)
        idx = vox.long()
        self.flat = (idx[..., 0] * n + idx[..., 1]) * z + idx[..., 2]
        self.phi = basis(2.0 * vox / norm_hi(size, vox) - 1.0)
        self.nb = self.flat.shape[1]


class Model:
    """The model of one configuration: volume, anchors, width, schedule."""

    def __init__(self, size, pos: torch.Tensor, sigma: float,
                 precision: str = "float32"):
        self.size = tuple(int(s) for s in size)
        self.p = self.size[0] * self.size[1] * self.size[2]
        self.pos = pos.to(torch.float32)
        self.sigma = float(sigma)
        self.plain = Plain(precision)
        self._boxes: Dict[tuple, Boxes] = {}

    def boxes(self, betas: torch.Tensor,
              excursion: Optional[torch.Tensor] = None) -> Boxes:
        half = reach(betas, self.size, self.sigma, excursion)
        if half not in self._boxes:
            self._boxes = {half: Boxes(self.pos, self.size, half)}
        return self._boxes[half]

    def psi(self, betas: torch.Tensor, box: Boxes) -> torch.Tensor:
        """Deformed coordinates ``[B, K, nb, 3]`` of each neuron's box for
        ``betas [B, 10, 3]``: one product ``[K nb, 10] @ [10, 3 B]``."""
        k, nb = box.flat.shape
        bsz = betas.shape[0]
        u = self.plain.mm(box.phi.reshape(k * nb, 10),
                          betas.permute(1, 0, 2).reshape(10, 3 * bsz))
        u = u.view(k, nb, bsz, 3).permute(2, 0, 1, 3)
        return (u + 1.0) * 0.5 * norm_hi(self.size, u)

    def beta_grad(self, dpsi: torch.Tensor, box: Boxes) -> torch.Tensor:
        """``d/d beta [B, 10, 3]`` from ``d/d psi [B, K, nb, 3]``: the
        chain through the denormalization and ``phi @ beta``, one product
        per neuron, summed."""
        bsz, k, nb, _ = dpsi.shape
        du = dpsi * (0.5 * norm_hi(self.size, dpsi))
        du = du.permute(1, 2, 0, 3).reshape(k, nb, 3 * bsz)
        g = self.plain.mm(box.phi.transpose(1, 2), du).sum(dim=0)
        return g.view(10, bsz, 3).permute(1, 0, 2)

    def gaussians(self, psi: torch.Tensor,
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Faded footprints ``[B, K, nb]`` at ``psi [B, K, nb, 3]``, centred
        on the anchors or on per-frame positions ``pos [B, K, 3]``."""
        centre = (self.pos[None, :, None, :] if pos is None
                  else pos[:, :, None, :])
        d2 = torch.sum((psi - centre) ** 2, dim=-1)
        return torch.exp(-d2 / (self.sigma * self.sigma)) * fade(psi,
                                                                 self.size)

    def footprints(self, betas: torch.Tensor, box: Boxes,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``A [B, K, nb]`` on each neuron's box for ``betas [B, 10, 3]``
        (at per-frame positions ``pos [B, K, 3]``, if given)."""
        return self.gaussians(self.psi(betas, box), pos)

    def recon(self, a: torch.Tensor, c: torch.Tensor,
              box: Boxes) -> torch.Tensor:
        """Frames ``[B, P]`` from footprints ``a [B, K, nb]`` and traces
        ``c [K, B]``."""
        vals = (a * c.T[:, :, None]).reshape(a.shape[0], -1)
        out = torch.zeros((a.shape[0], self.p), dtype=a.dtype,
                          device=a.device)
        return out.index_add(1, box.flat.reshape(-1), vals)

    def corner_reg(self, betas: torch.Tensor) -> torch.Tensor:
        """``log|det J(-1)|^2 + log|det J(1)|^2`` per frame ``[B]``."""
        out = 0.0
        for v in (-1.0, 1.0):
            # d phi / d u at u = (v, v, v), rows in basis order
            dphi = torch.tensor(
                [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [2 * v, 0, 0],
                 [0, 2 * v, 0], [0, 0, 2 * v], [v, v, 0], [v, 0, v],
                 [0, v, v]], dtype=betas.dtype, device=betas.device)
            j = self.plain.mm(betas.transpose(1, 2), dphi)
            det = (j[:, 0, 0] * (j[:, 1, 1] * j[:, 2, 2]
                                 - j[:, 1, 2] * j[:, 2, 1])
                   - j[:, 0, 1] * (j[:, 1, 0] * j[:, 2, 2]
                                   - j[:, 1, 2] * j[:, 2, 0])
                   + j[:, 0, 2] * (j[:, 1, 0] * j[:, 2, 1]
                                   - j[:, 1, 1] * j[:, 2, 0]))
            out = out + torch.log(torch.abs(det) + EPS) ** 2
        return out

    def frame_losses(self, betas, c, y, gamma, grad: bool, box=None):
        """Per-frame ``(mse [B], reg [B], d(mse + gamma reg)/d beta)``;
        ``box`` (default: this batch's) must hold the batch's warps.  The
        data term's gradient by autograd down to ``psi``, then
        :meth:`beta_grad`; the regularizer's by autograd."""
        box = box or self.boxes(betas)
        with torch.enable_grad():
            psi = self.psi(betas, box).detach().requires_grad_(grad)
            r = self.recon(self.gaussians(psi), c, box) - y
            mse = torch.sum(r * r, dim=1) / self.p
            b = betas.detach().requires_grad_(grad)
            reg = self.corner_reg(b)
            g = None
            if grad:
                (dpsi,) = torch.autograd.grad(torch.sum(mse), psi)
                (dreg,) = torch.autograd.grad(torch.sum(reg), b)
                g = self.beta_grad(dpsi, box) + gamma * dreg
        return mse.detach(), reg.detach(), g

    def position_losses(self, betas, pos, c, y, box):
        """Per-frame ``(mse [B], d mse / d pos [B, K, 3])`` at per-frame
        positions ``pos [B, K, 3]`` (``box`` must hold them), by
        autograd."""
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            r = self.recon(self.footprints(betas, box, p), c, box) - y
            mse = torch.sum(r * r, dim=1) / self.p
            (g,) = torch.autograd.grad(torch.sum(mse), p)
        return mse.detach(), g

    def c1_and_exact(self, betas, y, exact: bool, box=None, pos=None):
        """``(c1 [B, K], G [B, K, K] or None)``: the exact Gram from each
        frame's footprints scattered onto the whole volume; footprints at
        per-frame positions ``pos [B, K, 3]`` where given (``box`` must
        hold them)."""
        box = box or self.boxes(betas)
        a = self.footprints(betas, box, pos)  # [B, K, nb]
        c1 = torch.sum(a * y[:, box.flat], dim=-1)
        if not exact:
            return c1, None
        k = a.shape[1]
        grams = []
        col = torch.arange(k, device=a.device)[:, None].expand_as(box.flat)
        for i in range(a.shape[0]):
            dense = torch.zeros((self.p, k), dtype=a.dtype, device=a.device)
            dense[box.flat.reshape(-1), col.reshape(-1)] = a[i].reshape(-1)
            grams.append(self.plain.mm(dense.T, dense))
            del dense
        return c1, torch.stack(grams)

    def closed_form(self, betas: torch.Tensor, window: int,
                    pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        return closed_form_grams(betas, self.pos if pos is None else pos,
                                 self.sigma, self.size, window,
                                 mm=self.plain.mm)


# ----------------------------------------------------------------------
# The closed-form Gram (``gram_mode="analytic"``)
# ----------------------------------------------------------------------
def default_window(shape_std: float) -> int:
    return int(math.ceil(3.3 * float(shape_std))) + 2


def _inverse(points, betas, size, iters, mm):
    """``psi^{-1}`` of pixel-space points ``[B, K, 3]`` by the fixed-point
    iteration ``u <- u + (q - warp(u))`` in normalized space."""
    hi = norm_hi(size, points)
    q = 2.0 * points / hi - 1.0
    u = q
    for _ in range(iters):
        u = u + (q - mm(basis(u), betas))
    return (u + 1.0) * 0.5 * hi


def _warp(points, betas, size, mm):
    """Pixel-space warp of points ``[B, ..., 3]`` and the points in
    normalized space."""
    hi = norm_hi(size, points)
    u = 2.0 * points / hi - 1.0
    shape = u.shape
    out = mm(basis(u).reshape(shape[0], -1, 10), betas)
    return ((out + 1.0) * 0.5 * hi).reshape(shape), u


def _jac_diag(betas, u):
    """Diagonal of the normalized warp's Jacobian at ``u [B, ..., 3]``."""
    shape = (betas.shape[0],) + (1,) * (u.ndim - 2)

    def b(j, d):
        return betas[:, j, d].reshape(shape)

    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([
        b(1, 0) + 2 * x * b(4, 0) + y * b(7, 0) + z * b(8, 0),
        b(2, 1) + 2 * y * b(5, 1) + x * b(7, 1) + z * b(9, 1),
        b(3, 2) + 2 * z * b(6, 2) + x * b(8, 2) + y * b(9, 2)], dim=-1)


def closed_form_grams(betas: torch.Tensor, pos: torch.Tensor, sigma: float,
                      size, window: int, iters: int = 3,
                      plane_axis_max: int = 4, mm=torch.matmul
                      ) -> torch.Tensor:
    """``[B, K, K]``: ``G_kl = exp(-g |p_k - p_l|^2) S(m, c)``, the
    product of two Gaussians a Gaussian of precision ``c = 2 / s^2`` at
    the midpoint ``m``, and ``S`` the faded lattice sum of that Gaussian
    over the deformed voxels, with the warp linearized per axis around
    the inverse image of ``m`` (its own-axis curvature kept); an axis of
    at most ``plane_axis_max`` planes summed plane by plane.  ``pos``:
    the anchors ``[K, 3]`` or per-frame positions ``[B, K, 3]``."""
    size = tuple(int(s) for s in size)
    kw = dict(dtype=torch.float32, device=pos.device)
    top = torch.tensor([float(s - 1) for s in size], **kw)
    bsz, k = betas.shape[0], pos.shape[-2]
    ck = torch.full((1, k, 3), 1.0 / (sigma * sigma), **kw)
    c = ck[:, :, None, :] + ck[:, None, :, :]
    gamma = ck[:, :, None, :] * ck[:, None, :, :] / c
    wk, wl = ck[:, :, None, :] / c, ck[:, None, :, :] / c
    p = pos if pos.ndim == 3 else pos[None]
    pairfac = torch.exp(-torch.sum(
        gamma * (p[:, :, None, :] - p[:, None, :, :]) ** 2, dim=-1))
    m = wk * p[:, :, None, :] + wl * p[:, None, :, :]
    xk = _inverse(p.expand(bsz, k, 3), betas, size, iters, mm)
    xm = wk * xk[:, :, None, :] + wl * xk[:, None, :, :]
    xc = torch.minimum(torch.maximum(xm, torch.zeros((), **kw)), top)
    u0, xc_u = _warp(xc, betas, size, mm)
    jdd = _jac_diag(betas, xc_u)
    curv = [4.0 * betas[:, 4 + d, d] / max(size[d] - 1.0, 1.0)
            for d in range(3)]
    steps = torch.arange(2 * window + 1, **kw) - window

    def axis_sum(d, u0_d, jdd_d, xc_d, cb, m_d):
        h = curv[d].reshape((bsz,) + (1,) * u0_d.ndim)
        xs = torch.round(xc_d)[..., None] + steps
        ds = xs - xc_d[..., None]
        u = u0_d[..., None] + jdd_d[..., None] * ds + 0.5 * h * ds * ds
        ramp = torch.clamp(1.0 + torch.minimum(u, top[d] - u), 0.0, 1.0)
        val = ramp * ramp * torch.exp(-cb[..., None] * (u - m_d[..., None])
                                      ** 2)
        valid = (xs >= 0.0) & (xs <= top[d])
        return torch.sum(torch.where(valid, val, torch.zeros((), **kw)),
                         dim=-1)

    thin = min(range(3), key=lambda d: size[d])
    if size[thin] <= plane_axis_max:
        planes = torch.arange(size[thin], **kw)
        onehot = torch.tensor([1.0 if d == thin else 0.0 for d in range(3)],
                              **kw)
        xb = xc[..., None, :] * (1.0 - onehot) + planes[:, None] * onehot
        u0b, xb_u = _warp(xb, betas, size, mm)
        jddb = _jac_diag(betas, xb_u)
        ut = u0b[..., thin]
        ramp = torch.clamp(1.0 + torch.minimum(ut, top[thin] - ut), 0.0, 1.0)
        s = ramp * ramp * torch.exp(
            -c[..., thin, None] * (ut - m[..., thin, None]) ** 2)
        shape = s.shape
        for d in range(3):
            if d != thin:
                s = s * axis_sum(d, u0b[..., d], jddb[..., d],
                                 xc[..., d, None].expand(shape),
                                 c[..., d, None].expand(shape),
                                 m[..., d, None].expand(shape))
        return pairfac * torch.sum(s, dim=-1)
    s = torch.ones_like(u0[..., 0])
    for d in range(3):
        s = s * axis_sum(d, u0[..., d], jdd[..., d], xc[..., d],
                         c[..., d].expand_as(xc[..., d]),
                         m[..., d].expand_as(xc[..., d]))
    return pairfac * s


# ----------------------------------------------------------------------
# The schedule
# ----------------------------------------------------------------------
def initial_traces(num_neurons: int, num_frames: int, seed: int,
                   frames: Sequence[int], device) -> torch.Tensor:
    """The fit's starting traces ``[K, F]`` of ``frames``: ``torch.rand((K,
    T))`` from a CPU generator seeded with the optimizer's seed."""
    c = torch.rand((num_neurons, num_frames),
                   generator=torch.Generator().manual_seed(int(seed)))
    return c[:, list(frames)].to(device)


def _adam(beta, g, count, mu, nu, lr):
    mu = 0.1 * g + 0.9 * mu
    nu = 0.001 * (g * g) + 0.999 * nu
    count += 1
    mu_hat = mu / (1.0 - 0.9 ** count)
    nu_hat = nu / (1.0 - 0.999 ** count)
    return beta - lr * mu_hat / (torch.sqrt(nu_hat) + 1e-8), count, mu, nu


def _batches(n: int, per: int):
    return [(s, min(s + per, n)) for s in range(0, n, per)]


def passes(model: Model, beta: torch.Tensor,
           excursion: Optional[torch.Tensor] = None):
    """``(box, [(start, stop)])``: one box for all of ``beta [F, 10, 3]``
    (and positions within ``excursion`` of their anchors) and frame
    batches of about 2**25 footprint values each."""
    box = model.boxes(beta, excursion)
    per = max(1, (1 << 25) // (model.pos.shape[0] * box.nb))
    return box, _batches(beta.shape[0], per)


def losses(model: Model, beta, c, frames, gamma: float):
    """Per-frame ``(mse, reg)`` ``[F]`` of warps ``beta [F, 10, 3]`` and
    traces ``c [K, F]``; ``frames(start, stop)`` gives those frames
    ``[stop - start, P]``."""
    box, batches = passes(model, beta)
    out = [model.frame_losses(beta[s:e], c[:, s:e], frames(s, e), gamma,
                              False, box) for s, e in batches]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def follow(model: Model, y: torch.Tensor, beta0: torch.Tensor,
           c0: torch.Tensor, schedule: dict, audit_at: Optional[int] = None,
           gram_trust_tol: Optional[float] = 0.02) -> dict:
    """Run the fit's schedule on the frames ``y [F, P]`` from ``beta0 [F,
    10, 3]`` and ``c0 [K, F]``.

    ``schedule``: ``outer_rounds``, ``motion_epochs``, ``mu_iters``,
    ``learning_rate``, ``gamma_motion``, ``gram_mode`` (``"auto"``,
    ``"analytic"`` or ``"exact"``).  ``audit_at``: the position among the
    frames of the audit's frame (auto mode).  Returns ``beta``, ``c``,
    per-epoch ``mse`` and ``reg`` ``[E, F]``, the audit's ``rel_err``,
    and the Gram mode the rounds after it took."""
    beta, c = beta0.clone(), c0.clone()
    mu, nu, count = torch.zeros_like(beta), torch.zeros_like(beta), 0
    lr, gamma = schedule["learning_rate"], schedule["gamma_motion"]
    mode = schedule["gram_mode"]
    window = default_window(model.sigma)
    mses: List[torch.Tensor] = []
    regs: List[torch.Tensor] = []
    rel = None
    for r in range(schedule["outer_rounds"]):
        for _ in range(schedule["motion_epochs"]):
            box, batches = passes(model, beta)
            parts = [model.frame_losses(beta[s:e], c[:, s:e], y[s:e], gamma,
                                        True, box) for s, e in batches]
            mses.append(torch.cat([p[0] for p in parts]))
            regs.append(torch.cat([p[1] for p in parts]))
            g = torch.cat([p[2] for p in parts])
            beta, count, mu, nu = _adam(beta, g, count, mu, nu, lr)
        if mode == "auto":
            mode = "analytic"
            if audit_at is not None and gram_trust_tol is not None:
                one = beta[audit_at:audit_at + 1]
                _, exact = model.c1_and_exact(one, y[audit_at:audit_at + 1],
                                              True)
                closed = model.closed_form(one, window)
                rel = float(torch.max(torch.abs(closed - exact))
                            / torch.clamp_min(torch.max(torch.abs(exact)),
                                              1e-30))
                if rel > gram_trust_tol:
                    mode = "exact"
        box, batches = passes(model, beta)
        c1s, grams = [], []
        for s, e in batches:
            c1, g_ex = model.c1_and_exact(beta[s:e], y[s:e], mode == "exact",
                                          box)
            c1s.append(c1)
            grams.append(g_ex if mode == "exact"
                         else model.closed_form(beta[s:e], window))
        c1, grams = torch.cat(c1s), torch.cat(grams)  # [F, K], [F, K, K]
        for _ in range(schedule["mu_iters"]):
            c2 = model.plain.mm(grams, c.T[:, :, None])[..., 0].T
            c = c * c1.T / (c2 + EPS)
    return {"beta": beta, "c": c, "mse": torch.stack(mses),
            "reg": torch.stack(regs), "rel_err": rel, "gram_mode": mode}


def _excursion(pos: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Per axis ``[3]``: the largest distance of ``pos [F, K, 3]`` from
    the anchors."""
    return (pos - anchors).abs().amax(dim=(0, 1))


def follow_refine(model: Model, y: torch.Tensor, beta: torch.Tensor,
                  c: torch.Tensor, schedule: dict, gram_mode: str) -> dict:
    """Run ``refine``'s schedule on the frames ``y [F, P]`` after the fit,
    from its warps ``beta [F, 10, 3]`` and traces ``c [K, F]``.

    ``schedule``: ``rounds``, ``epochs``, ``mu_iters``, ``learning_rate``
    (pixels), ``prior``.  Each round takes ``epochs`` Adam steps on the
    positions ``pos_t [F, K, 3]`` (the anchors at the first round, the
    last round's after it; a fresh Adam each round) on the data gradient
    plus the tether's ``2 prior / K (pos_t - anchor)``, then the Grams and
    ``c1`` at ``pos_t`` in ``gram_mode`` (the fit's audit's choice) and
    ``mu_iters`` multiplicative updates.  The warps are kept.  Returns
    ``pos`` ``[F, K, 3]``, ``c`` and the last epoch's ``mse [F]`` (before
    its step).

    Departures from the port's ``models/refine.py``: the footprints live
    on the boxes, the port's kernels cull at a reach of their own (both
    far below float32's resolution of a footprint's peak); Adam's bias
    corrections are Python floats here, float32 powers of the device
    count there.
    """
    f, k = beta.shape[0], model.pos.shape[0]
    anchors = model.pos
    pos = anchors.expand(f, k, 3).clone()
    lr, prior = schedule["learning_rate"], schedule["prior"]
    window = default_window(model.sigma)
    mse = None
    for _ in range(schedule["rounds"]):
        mu, nu, count = torch.zeros_like(pos), torch.zeros_like(pos), 0
        for _ in range(schedule["epochs"]):
            box, batches = passes(model, beta, _excursion(pos, anchors))
            parts = [model.position_losses(beta[s:e], pos[s:e], c[:, s:e],
                                           y[s:e], box) for s, e in batches]
            mse = torch.cat([p[0] for p in parts])
            g = torch.cat([p[1] for p in parts])
            g = g + (2.0 * prior / k) * (pos - anchors)
            pos, count, mu, nu = _adam(pos, g, count, mu, nu, lr)
        box, batches = passes(model, beta, _excursion(pos, anchors))
        c1s, grams = [], []
        for s, e in batches:
            c1, g_ex = model.c1_and_exact(beta[s:e], y[s:e],
                                          gram_mode == "exact", box,
                                          pos[s:e])
            c1s.append(c1)
            grams.append(g_ex if gram_mode == "exact"
                         else model.closed_form(beta[s:e], window, pos[s:e]))
        c1, grams = torch.cat(c1s), torch.cat(grams)
        for _ in range(schedule["mu_iters"]):
            c2 = model.plain.mm(grams, c.T[:, :, None])[..., 0].T
            c = c * c1.T / (c2 + EPS)
    return {"pos": pos, "c": c, "mse": mse}
