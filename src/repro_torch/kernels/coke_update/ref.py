"""Plain PyTorch versions of the two COKE kernels.

`coke_update_ref` is the elementwise version of `coke_fused_update` (K3),
in the reference expression's order. `coke_megastep_ref` has the contract
of `coke_megastep` (K2), as einsums, but is a pure function: it returns a
new theta and leaves its inputs untouched. It reads Phi twice (once per
einsum); the kernel reads it once. `residual_sq` is its per-agent sum of
squared residuals, which the megakernel path also takes for the train MSE
of a chunk's last iteration, so that on the CPU that value has the same
bits as the one the plain version returns.
"""
import torch

from repro_torch.kernels.coke_update.coke_update import megastep_scalars


def coke_update_ref(theta, theta_hat, gamma, grad, left, right, *, rho,
                    deg=2.0):
    """-> (g_aug (N, D) fp32, xi_sq (N,) fp32), the squared censor norm."""
    f = lambda a: a.to(torch.float32)
    gaug = (f(grad) + 2.0 * rho * deg * f(theta) + f(gamma)
            - rho * (deg * f(theta_hat) + f(left) + f(right)))
    xi = f(theta_hat) - f(theta)
    return gaug, torch.sum(xi * xi, dim=-1)


def residual_sq(phi, theta, y):
    """-> (N,) sum_t (phi_t . theta - y_t)^2 per agent."""
    resid = torch.einsum("ntd,nd->nt", phi, theta) - y
    return torch.sum(resid * resid, dim=-1)


def coke_megastep_ref(theta, theta_hat, gamma, phi, y, *, rho, lam, lr,
                      offsets=(1,), return_resid_sq=False):
    """-> (theta_new (N, D), xi_sq (N,)) with
    xi_sq = ||theta_new - theta_hat||^2, and resid_sq (N,) of the incoming
    theta (`residual_sq`) after them when `return_resid_sq`."""
    N, T, _ = phi.shape
    sc = megastep_scalars(rho=rho, lam=lam, lr=lr, n_agents=N, n_samples=T,
                          n_offsets=len(offsets))
    resid = torch.einsum("ntd,nd->nt", phi, theta) - y
    g_data = sc["inv_t2"] * torch.einsum("nt,ntd->nd", resid, phi)
    acc = sc["deg"] * theta_hat
    for o in offsets:
        acc = acc + torch.roll(theta_hat, -o, 0)   # row i reads hat[i + o]
        acc = acc + torch.roll(theta_hat, o, 0)    # row i reads hat[i - o]
    gaug = (g_data + sc["lam2"] * theta + sc["rho2deg"] * theta + gamma
            - sc["rho"] * acc)
    theta_new = theta - sc["lr"] * gaug
    d = theta_new - theta_hat
    xi_sq = torch.sum(d * d, dim=-1)
    if return_resid_sq:
        return theta_new, xi_sq, torch.sum(resid * resid, dim=-1)
    return theta_new, xi_sq
