"""Plain PyTorch version of the flash-attention kernel: naive full-matrix
softmax attention with the same causal / sliding-window mask semantics."""
import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k/v: (B, KV, Sk, *) with KV dividing H (query
    head h reads KV head h // (H // KV)) -> (B, H, Sq, Dv).

    Computed in fp32, returned in q's dtype. Query i and key j are at
    positions i and j. A query row that no key may see (only with a window
    and Sq > Sk + window - 1) is 0, as in the kernel; the reference's
    `attention_ref` averages every key's value there (ROADMAP Queue 3)."""
    H, Sq, Sk = q.shape[1], q.shape[2], k.shape[2]
    rep = H // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window:
        valid &= k_pos > q_pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
