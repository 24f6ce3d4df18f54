"""The decoder-only dense language model and its serving steps.

Port of the decoder-only dense part of `repro/models/model.py`: the model
is an `nn.Module` holding the embedding, an `nn.ModuleList` of dense
blocks, the final norm and the LM head, and every pass is a Python loop
over the blocks (the reference stacks the layers and scans). The public
entry points keep the reference's names and arguments, with the module in
the place of the param pytree:

  init_params, forward(batch) -> (logits, aux), loss_fn,
  init_serve_state, prefill, prefill_with_state, decode_step.

Training differentiates a dict of tensors by parameter name
(`param_dict`), put in the places of a module's weights by
`torch.func.functional_call` on a shapes-only `skeleton`: `loss_fn` takes
either. The reference's `cfg.remat` (jax.checkpoint around each layer) is
not mapped: activations are kept, and each layer runs its attention
kernel once forward and once backward.

Hybrid, enc-dec, MoE, SSM and MLA models raise NotImplementedError naming
`common.LATER_ARCHS`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.common import (LATER_ARCHS, ModelConfig, dense_init,
                                       frozen, init_device, rms_norm)


def layer_kind(cfg: ModelConfig) -> str:
    return {"moe": "moe", "ssm": "ssm", "hybrid": "ssm"}.get(
        cfg.arch_type, "dense")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a model kind the port does not run."""
    what = None
    if cfg.is_encdec:
        what = "enc-dec models"
    elif cfg.arch_type == "hybrid":
        what = "hybrid models"
    elif layer_kind(cfg) != "dense":
        what = f"{layer_kind(cfg)} layers"
    elif cfg.attn_kind != "gqa":
        what = f"attn_kind={cfg.attn_kind!r}"
    if what:
        raise NotImplementedError(f"{cfg.name}: {what} are not ported: "
                                  f"{LATER_ARCHS}")


class LM(nn.Module):
    """Decoder-only dense LM weights: embed (Vp, d), blocks, final_norm (d,)
    and lm_head (d, Vp), Vp the padded vocabulary. Drawn from `generator`
    on its device, or allocated and not drawn when generator is None
    (weights that are loaded next; `device` None means "cuda")."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        check_ported(cfg)
        dev = init_device(generator, device)
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = frozen(dense_init(generator, (Vp, d), cfg.dtype,
                                       fan_in=d, device=dev))
        self.final_norm = frozen(torch.ones((d,), dtype=cfg.dtype,
                                            device=dev))
        self.lm_head = frozen(dense_init(generator, (d, Vp), cfg.dtype,
                                         device=dev))
        self.blocks = nn.ModuleList(
            blk.DenseBlock(cfg, generator, device=dev)
            for _ in range(cfg.num_layers))

    def forward(self, cfg: ModelConfig, batch: dict):
        """The module-level `forward` on this module's weights (the entry
        `torch.func.functional_call` calls)."""
        return forward(self, cfg, batch)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """The model with weights drawn from `generator`, on its device."""
    return LM(cfg, generator)


def param_dict(model: LM) -> dict[str, torch.Tensor]:
    """{parameter name: tensor} of `model`, sharing its storage."""
    return {n: p.detach() for n, p in model.named_parameters()}


def skeleton(cfg: ModelConfig) -> LM:
    """The model's structure on the meta device: no weights are allocated;
    `loss_fn` puts a dict of tensors in their places."""
    return LM(cfg, device="meta")


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict):
    """Token embedding. Returns (x, positions, text_offset); the port takes
    no multimodal prefix, so the offset is 0."""
    if cfg.prefix_len and "prefix_embeds" in batch:
        raise NotImplementedError("multimodal prefix embeddings are not "
                                  f"ported: {LATER_ARCHS}")
    x = F.embedding(batch["tokens"], params.embed)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions, 0


def _decoder_only_forward(params: LM, cfg: ModelConfig, x, positions):
    kind = layer_kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.blocks:
        x, a = blk.block_forward(lp, cfg, x, positions, kind)
        aux = aux + a
    return x, aux


def forward(params: LM, cfg: ModelConfig, batch: dict):
    """-> (logits over the padded vocab aligned with batch['tokens'], aux)."""
    check_ported(cfg)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    x, aux = _decoder_only_forward(params, cfg, x, positions)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, aux


def loss_fn(params, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01,
            *, model: LM | None = None):
    """Mean next-token NLL (log-softmax in fp32) plus aux_weight * aux.
    `params`: an LM, or a dict of tensors by parameter name run through
    `model` (a skeleton of the same config, made here when None) by
    `torch.func.functional_call`. Returns (loss, {"nll", "aux"})."""
    if isinstance(params, LM):
        logits, aux = forward(params, cfg, batch)
    else:
        logits, aux = torch.func.functional_call(
            skeleton(cfg) if model is None else model, params, (cfg, batch))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = torch.mean(nll) + aux_weight * aux
    return loss, {"nll": torch.mean(nll), "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=None, enc_len: int = 0, *,
                     device: torch.device | str | None = None) -> dict:
    """Empty caches for decode from scratch: {"layers": [KVCache per
    layer]} (the reference stacks them along a leading layer axis)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    kind = layer_kind(cfg)
    return {"layers": [blk.block_empty_cache(cfg, kind, batch, cache_len,
                                             dtype, dev)
                       for _ in range(cfg.num_layers)]}


@torch.inference_mode()
def decode_step(params: LM, cfg: ModelConfig, token: torch.Tensor,
                state: dict, position: int):
    """token: (B, 1) ints -> (logits (B, 1, Vp), state). The caches of
    `state` are updated in place and returned in it."""
    check_ported(cfg)
    x = F.embedding(token, params.embed)
    kind = layer_kind(cfg)
    caches = []
    for lp, cache in zip(params.blocks, state["layers"]):
        x, cache = blk.block_decode(lp, cfg, x, None, kind, cache, position)
        caches.append(cache)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, {"layers": caches}


@torch.inference_mode()
def prefill(params: LM, cfg: ModelConfig, batch: dict):
    """Full-sequence pass returning last-position logits (B, 1, Vp)."""
    check_ported(cfg)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    x, _ = _decoder_only_forward(params, cfg, x, positions)
    # rms_norm and the head act on each position alone: the last position's
    # logits need neither the other positions nor an (S, Vp) product
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return x @ params.lm_head


@torch.inference_mode()
def prefill_with_state(params: LM, cfg: ModelConfig, batch: dict,
                       cache_len: int):
    """One full-sequence pass that also builds the decode caches — the
    production prefill path. Returns (last-position logits, serve state)."""
    check_ported(cfg)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    kind = layer_kind(cfg)
    caches = []
    for lp in params.blocks:
        x, _, cache = blk.block_forward(lp, cfg, x, positions, kind,
                                        cache_len=cache_len)
        caches.append(cache)
    # the head on the last position only: the same logits as the
    # reference's (x @ lm_head)[:, -1:], without an (S, Vp) product
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, {"layers": caches}
