"""Mamba2 (SSD — state-space duality) mixer.

Port of `repro/models/ssm.py`. Prefill and training use the chunked SSD
algorithm (arXiv:2405.21060): quadratic attention-like compute inside
chunks of length Q, a linear recurrence across chunk boundaries. Decode is
the O(1) recurrent update on the (B, H, P, N) state.

The reference scans the whole chunk step over the chunks (`lax.scan`).
The port splits it by what depends on the carried state: every
elementwise pass, the chunk-end state contributions and the inter-chunk
output run once over all chunks; only the recurrence itself (one
`addcmul` per chunk) loops; the intra-chunk (Q, Q) scores run over groups
of chunks whose (B, g, H, Q, Q) tensors hold at most `SSD_GROUP_ELEMS`
elements, so live memory stays O(B Q^2 H) per group at long prompts. No
kernel of the port's own: the reference computes the scan inside XLA, with
no Pallas kernel, and the port's ops are ATen's.

The three-operand einsums of the reference run pairwise, in an order whose
intermediates are no larger than (B, Q, H, P) per chunk; the masked
(upper-triangle) decay exponents are set to -inf before `exp`, so no
inf · 0 reaches an unmasked score.

Projection layout as the reference's: separate head-aligned projections
w_z, w_x, w_bc and w_dt, not one fused in_proj.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, at_least_fp32,
                                       dense_init, frozen, init_device,
                                       rms_norm)

#: elements of one (B, g, H, Q, Q) intra-chunk tensor at most: the group
#: of g chunks whose scores are formed at once (256 MiB of fp32)
SSD_GROUP_ELEMS = 1 << 26


class SSMCache(NamedTuple):
    conv_x: torch.Tensor   # (B, W-1, d_inner) trailing conv inputs (x path)
    conv_bc: torch.Tensor  # (B, W-1, 2N) trailing conv inputs (B/C path)
    state: torch.Tensor    # (B, H, P, N) recurrent state, fp32


class SSM(nn.Module):
    """The weights of one Mamba2 mixer, named as the reference's param
    dict: w_z, w_x (d, d_inner), w_bc (d, 2N), w_dt (d, H), conv_x
    (W, d_inner), conv_bc (W, 2N), conv_bx (d_inner,), conv_bbc (2N,),
    A_log, D and dt_bias (H,) in fp32 whatever `cfg.dtype` is, norm
    (d_inner,), out_proj (d_inner, d). Drawn from `generator` on its device
    (dt_bias so that softplus(dt_bias) spans ~[1e-3, 1e-1], the mamba2
    default), or allocated and not drawn when generator is None (weights
    that are loaded next)."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        dev = init_device(generator, device)
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        W = cfg.ssm_conv_width
        f32 = torch.float32

        def draw(shape, fan_in=None):
            return frozen(dense_init(generator, shape, cfg.dtype, fan_in,
                                     device=dev))

        if generator is None:
            dt_bias = torch.empty((H,), dtype=f32, device=dev)
        else:
            u = torch.rand((H,), generator=generator, dtype=f32, device=dev)
            lo, hi = math.log(1e-3), math.log(0.1)
            dt0 = torch.exp(u * (hi - lo) + lo)
            dt_bias = dt0 + torch.log(-torch.expm1(-dt0))   # inverse softplus
        self.w_z = draw((d, di))
        self.w_x = draw((d, di))
        self.w_bc = draw((d, 2 * N))
        self.w_dt = draw((d, H))
        self.conv_x = draw((W, di), fan_in=W)
        self.conv_bc = draw((W, 2 * N), fan_in=W)
        self.conv_bx = frozen(torch.zeros((di,), dtype=cfg.dtype,
                                          device=dev))
        self.conv_bbc = frozen(torch.zeros((2 * N,), dtype=cfg.dtype,
                                           device=dev))
        self.A_log = frozen(torch.log(torch.arange(1, H + 1, dtype=f32,
                                                   device=dev)))
        self.D = frozen(torch.ones((H,), dtype=f32, device=dev))
        self.dt_bias = frozen(dt_bias)
        self.norm = frozen(torch.ones((di,), dtype=cfg.dtype, device=dev))
        self.out_proj = draw((di, d), fan_in=di)


def init_ssm_params(cfg: ModelConfig, generator: torch.Generator) -> SSM:
    return SSM(cfg, generator)


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None):
    """Depthwise causal conv along S. xc: (B, S, ch); w: (W, ch).
    prev: (B, W-1, ch) trailing context (decode) or None (zero left-pad).
    Returns (silu(conv + b), the last W-1 inputs as a tensor of its own)."""
    W = w.shape[0]
    if prev is None:
        prev = xc.new_zeros((xc.shape[0], W - 1, xc.shape[-1]))
    xp = torch.cat([prev, xc], dim=1)
    S = xc.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    # the tail is copied out, so that a cache does not keep xp alive
    return F.silu(out + b), xp[:, -(W - 1):].clone()


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N). Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32, or float64 for float64 x). S is padded to a
    multiple of the chunk with zero steps (dt = 0), which leave the state
    as it is."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, dt, Bm, Cm = (t.to(acc) for t in (x, dt, Bm, Cm))
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xc = x32.reshape(B_, nc, Q, H, P)
    Bc = Bm.reshape(B_, nc, Q, N)
    Cc = Cm.reshape(B_, nc, Q, N)
    # per chunk and head, along the chunk's positions: (B, nc, H, Q)
    dtc = dt.reshape(B_, nc, Q, H).transpose(2, 3).contiguous()
    cum = torch.cumsum(dtc * A[:, None], dim=-1)

    # chunk-end state contributions, every chunk at once:
    # sum_j B_j x_j dt_j exp(cum_last - cum_j), dt and the decay folded
    # into x first
    w = torch.exp(cum[..., -1:] - cum) * dtc
    xw = xc * w.transpose(2, 3)[..., None]
    contrib = torch.einsum("bcjhp,bcjn->bchpn", xw, Bc)
    total = torch.exp(cum[..., -1])                        # (B, nc, H)

    # the recurrence across chunks: the state entering each chunk
    state = (torch.zeros((B_, H, P, N), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = torch.addcmul(contrib[:, c], state,
                              total[:, c, :, None, None])
    states = torch.stack(entering, dim=1)                  # (B, nc, H, P, N)

    # inter-chunk output: C_i . state, decayed to position i
    y_inter = (torch.einsum("bcin,bchpn->bcihp", Cc, states)
               * torch.exp(cum).transpose(2, 3)[..., None])

    # intra-chunk output over groups of chunks: scores (B, g, H, i, j) =
    # (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, 0 above
    cb = (Cc @ Bc.transpose(-1, -2))[:, :, None]            # (B, nc, 1, Q, Q)
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    g = max(1, SSD_GROUP_ELEMS // (B_ * H * Q * Q))
    ys = []
    for c0 in range(0, nc, g):
        sl = slice(c0, c0 + g)
        cq = cum[:, sl]
        diff = cq[..., :, None] - cq[..., None, :]
        decay = torch.exp(diff.masked_fill_(above, -math.inf))
        scores = cb[:, sl] * decay * dtc[:, sl, :, None, :]
        ys.append((scores @ xc[:, sl].transpose(2, 3)).transpose(2, 3))
    y = torch.cat(ys, dim=1) + y_inter
    y = y.reshape(B_, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), state


def _project(params: SSM, cfg: ModelConfig, x: torch.Tensor):
    z = x @ params.w_z
    xs = x @ params.w_x
    bc = x @ params.w_bc
    dt = x @ params.w_dt
    return z, xs, bc, dt


def ssm_forward(params: SSM, cfg: ModelConfig, x: torch.Tensor,
                return_cache: bool = False):
    """Full-sequence mixer. x: (B, S, d) -> (B, S, d) [, SSMCache]."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xs, bc, dt = _project(params, cfg, x)
    xs, tail_x = _causal_conv(xs, params.conv_x, params.conv_bx)
    bc, tail_bc = _causal_conv(bc, params.conv_bc, params.conv_bbc)
    xs = xs.reshape(B, S, H, P)
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = F.softplus(at_least_fp32(dt) + params.dt_bias)
    A = -torch.exp(params.A_log)
    y, state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + params.D.to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params.norm, cfg.norm_eps)
    out = y @ params.out_proj
    if return_cache:
        return out, SSMCache(conv_x=tail_x, conv_bc=tail_bc, state=state)
    return out


def ssm_decode(params: SSM, cfg: ModelConfig, x: torch.Tensor,
               cache: SSMCache):
    """Single-token recurrent update. x: (B, 1, d). Returns (out (B, 1, d),
    cache).

    Unlike the reference, which returns a new cache, the port updates the
    conv tails and the state of `cache` in place and returns it."""
    B = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xs, bc, dt = _project(params, cfg, x)
    xs, tail_x = _causal_conv(xs, params.conv_x, params.conv_bx,
                              prev=cache.conv_x)
    bc, tail_bc = _causal_conv(bc, params.conv_bc, params.conv_bbc,
                               prev=cache.conv_bc)
    cache.conv_x.copy_(tail_x)
    cache.conv_bc.copy_(tail_bc)
    xs1 = at_least_fp32(xs[:, 0].reshape(B, H, P))
    Bm, Cm = at_least_fp32(bc[:, 0, :N]), at_least_fp32(bc[:, 0, N:])
    dt1 = F.softplus(at_least_fp32(dt[:, 0]) + params.dt_bias)
    A = -torch.exp(params.A_log)
    dA = torch.exp(dt1 * A)                                  # (B, H)
    # state <- state * dA + (x dt) outer B
    state = cache.state.mul_(dA[:, :, None, None]).addcmul_(
        (xs1 * dt1[:, :, None])[..., None], Bm[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + params.D[None, :, None] * xs1
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params.norm, cfg.norm_eps)
    return y @ params.out_proj, cache
