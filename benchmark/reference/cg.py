"""Plain conjugate gradients, as the solvers the benchmark judges state
them: one CG a column (its own ``alpha`` and ``beta``), from a zero
start, the columns in groups (a fit's classes, or a trial's) that each
stop at the first step where the Frobenius norm of their residual is at
most ``tol``, clamped to ``50 eps (||b|| + 1)`` with ``eps`` that of the
program's working precision (float32 on the card, as the configurations
state; float64 on the CPU).  A stopped
group is left as it is.

Besides the iterate at the stop, :func:`cg` returns the iterates one step
before it and one step after it: a program in float32 may stop one step
off the float64 stop, and an answer is judged against the nearest of the
three."""

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)


def cg(A, b, group, tol, M=None, max_iter=10**5, eps=EPS32):
    """``A`` and ``M`` act on (n, c) tensors; ``b`` (n, c); ``group`` the
    number of columns a group holds.  Returns ``(x_before, x, x_after,
    iters)``, ``iters`` a numpy array of the groups' stops."""
    n, c = b.shape
    G = c // group
    if M is None:
        M = lambda r: r

    def gnorm(R):
        return torch.linalg.vector_norm(
            R.to(torch.float64).reshape(n, G, group), dim=(0, 2))

    tols = torch.clamp(50.0 * eps * (gnorm(b) + 1.0), min=float(tol))
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    iters = np.zeros(G, dtype=np.int64)
    before = x.clone()
    after = None
    done = np.zeros(G, dtype=bool)
    extra = np.zeros(G, dtype=bool)      # the step after the stop is taken
    while True:
        active = (gnorm(r) > tols).cpu().numpy() & (iters < max_iter)
        done |= ~active
        step = active | (done & ~extra)  # one more step past each stop
        if not step.any():
            break
        on = torch.as_tensor(np.repeat(active, group), device=b.device)
        Ap = A(p)
        pAp = torch.sum(p * Ap, dim=0)
        alpha = torch.where(pAp != 0, rz / torch.where(pAp == 0, 1, pAp), 0)
        x_new = x + alpha[None, :] * p
        r_new = r - alpha[None, :] * Ap
        z_new = M(r_new)
        rz_new = torch.sum(r_new * z_new, dim=0)
        beta = torch.where(rz != 0, rz_new / torch.where(rz == 0, 1, rz), 0)
        if after is None:
            after = x.clone()
        post = torch.as_tensor(np.repeat(step & ~active, group),
                               device=b.device)
        after = torch.where(post[None, :], x_new, after)
        before = torch.where(on[None, :], x, before)
        x = torch.where(on[None, :], x_new, x)
        p = torch.where(on[None, :], z_new + beta[None, :] * p, p)
        r = torch.where(on[None, :], r_new, r)
        rz = torch.where(on, rz_new, rz)
        iters += active
        extra |= step & ~active
    if after is None:
        after = x.clone()
    return before, x, after, iters
