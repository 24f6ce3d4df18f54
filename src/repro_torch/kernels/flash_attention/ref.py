"""Plain PyTorch versions of the flash-attention kernels: naive full-matrix
softmax attention with the same causal / sliding-window mask semantics
(K4, and the log-sum-exp K4 writes for training), and its backward (K7).
All take (B, H, S, D) q and (B, KV, S, *) k/v with KV dividing H."""
import torch

NEG_INF = -1e30


def _scores(q, k, causal, window):
    """fp32 scaled scores (B, H, Sq, Sk) against K repeated to H heads, and
    the (Sq, Sk) mask of admissible pairs."""
    H, Sq, Sk = q.shape[1], q.shape[2], k.shape[2]
    rep = H // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window:
        valid &= k_pos > q_pos - window
    return s, valid


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k/v: (B, KV, Sk, *) with KV dividing H (query
    head h reads KV head h // (H // KV)) -> (B, H, Sq, Dv).

    Computed in fp32, returned in q's dtype. Query i and key j are at
    positions i and j. A query row that no key may see (only with a window
    and Sq > Sk + window - 1) is 0, as in the kernel; the reference's
    `attention_ref` averages every key's value there (ROADMAP Queue 3)."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=1)
    s, valid = _scores(q, k, causal, window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """The per-row log-sum-exp of the scaled admissible scores that K4
    writes for training: fp32 (B, H, Sq), +inf for a row no key may see."""
    s, valid = _scores(q, k, causal, window)
    lse = torch.logsumexp(torch.where(valid, s, -torch.inf), dim=-1)
    return torch.where(valid.any(dim=-1), lse, torch.inf)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int = 0):
    """(dq, dk, dv) of `attention_ref` at the output gradient `do`, by the
    formulas K7 evaluates, in fp32: P the masked softmax, dV = P^T dO,
    dP = dO V^T, delta = rowsum(dO * O) from the forward's output `o`,
    dS = P (dP - delta) scale, dQ = dS K, dK = dS^T Q; dK and dV summed
    over the query heads of each KV group. Returned in q's dtype and the
    layouts of q, k and v."""
    B, H, Sq, Dh = q.shape
    KV = k.shape[1]
    rep = H // KV
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s, valid = _scores(q, k, causal, window)
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    p = p * valid.any(dim=-1, keepdim=True)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = torch.sum(dof * o.float(), dim=-1, keepdim=True)
    ds = p * (dp - delta) / (Dh ** 0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    if rep > 1:
        dk = dk.reshape(B, KV, rep, *dk.shape[2:]).sum(dim=2)
        dv = dv.reshape(B, KV, rep, *dv.shape[2:]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
