"""The language models and their serving steps.

Port of `repro/models/model.py`: the model is an `nn.Module` holding the
embedding, the layers, the final norm and the LM head, and every pass is
a Python loop over the layers (the reference stacks the layers and
scans). Three templates, as in the reference:

  * decoder-only: an `nn.ModuleList` of blocks (dense or MoE, with GQA or
    MLA attention, or Mamba2 SSM blocks: `layer_kind`); the VLM backbone
    (internvl2) is one, with `batch["prefix_embeds"]`, the stub's patch
    embeddings, before the token embeddings;
  * the grouped hybrid (zamba2): its SSM blocks a ModuleList of groups of
    `shared_attn_every`, each group followed by one application of
    `shared_attn`, a dense GQA block whose weights every application
    shares; each application keeps its own KV cache;
  * encoder-decoder (seamless-m4t): `encoder`, dense blocks run without
    the causal mask over `batch["encoder_embeds"]`, the stub's frame
    embeddings, then `enc_norm`; `decoder`, `blocks.CrossBlock`s, each
    attending to the memory's k/v projected by its own cross attention.

The public entry points keep the reference's names and arguments, with
the module in the place of the param pytree:

  init_params, forward(batch) -> (logits, aux), loss_fn,
  init_serve_state, prefill, prefill_with_state, decode_step.

Training differentiates a dict of tensors by parameter name
(`param_dict`), put in the places of a module's weights by
`torch.func.functional_call` on a shapes-only `skeleton`: `loss_fn` takes
either. The reference's `cfg.remat` (jax.checkpoint around each layer) is
not mapped: activations are kept, and each layer runs its attention
kernel once forward and once backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import blocks as blk
from repro_torch.models.common import (ModelConfig, dense_init, frozen,
                                       init_device, rms_norm)


def layer_kind(cfg: ModelConfig) -> str:
    return {"moe": "moe", "ssm": "ssm", "hybrid": "ssm"}.get(
        cfg.arch_type, "dense")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ValueError for a config no model of the reference's takes."""
    if cfg.arch_type == "ssm":
        return
    if cfg.attn_kind not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: attn_kind={cfg.attn_kind!r} "
                         "outside an SSM model")
    if cfg.arch_type == "hybrid" and not (
            cfg.shared_attn_every
            and cfg.num_layers % cfg.shared_attn_every == 0):
        raise ValueError(f"{cfg.name}: a hybrid needs num_layers "
                         f"({cfg.num_layers}) a multiple of "
                         f"shared_attn_every ({cfg.shared_attn_every})")


class LM(nn.Module):
    """LM weights: embed (Vp, d), final_norm (d,) and lm_head (d, Vp), Vp
    the padded vocabulary; a decoder-only model's blocks (the `layer_kind`
    block's, `blocks.BLOCKS`), where a hybrid's are groups of
    `shared_attn_every` SSM blocks (blocks.g.e) and shared_attn is its one
    dense block; an enc-dec model's encoder (`encoder_layers` dense
    blocks), enc_norm (d,) and decoder (`num_layers` CrossBlocks), and no
    blocks, as in the reference's tree. Drawn from `generator` on its
    device, or allocated and not drawn when generator is None (weights
    that are loaded next; `device` None means "cuda")."""

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
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(
                blk.DenseBlock(cfg, generator, device=dev)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = frozen(torch.ones((d,), dtype=cfg.dtype,
                                              device=dev))
            self.decoder = nn.ModuleList(
                blk.CrossBlock(cfg, generator, device=dev)
                for _ in range(cfg.num_layers))
            return
        block = blk.BLOCKS[layer_kind(cfg)]
        if cfg.arch_type == "hybrid":
            every = cfg.shared_attn_every
            self.blocks = nn.ModuleList(
                nn.ModuleList(block(cfg, generator, device=dev)
                              for _ in range(every))
                for _ in range(cfg.num_layers // every))
            self.shared_attn = blk.DenseBlock(cfg, generator, device=dev)
        else:
            self.blocks = nn.ModuleList(block(cfg, generator, device=dev)
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


def param_shapes(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """{parameter name: meta tensor} of the model: the skeleton's weights,
    shapes and dtypes that allocate nothing (the reference's
    ShapeDtypeStruct tree, one leaf per layer)."""
    return param_dict(skeleton(cfg))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(params: LM, cfg: ModelConfig, batch: dict):
    """Token embedding + optional multimodal prefix. Returns (x, positions,
    text_offset) where rows text_offset: of x align with batch tokens."""
    x = F.embedding(batch["tokens"], params.embed)
    offset = 0
    if cfg.prefix_len and "prefix_embeds" in batch:
        prefix = batch["prefix_embeds"]
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
        offset = prefix.shape[1]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions, offset


def _schedule(params: LM, cfg: ModelConfig) -> list:
    """(block, kind) in the order a pass applies them: every layer, and in
    a hybrid each group of SSM blocks followed by the shared block."""
    if cfg.arch_type != "hybrid":
        kind = layer_kind(cfg)
        return [(lp, kind) for lp in params.blocks]
    return [pair for group in params.blocks
            for pair in [*((lp, "ssm") for lp in group),
                         (params.shared_attn, "dense")]]


def _serve_state(cfg: ModelConfig, kinds, caches) -> dict:
    """The serve state from the caches of a pass, in `_schedule`'s order:
    {"layers": [...]}, or a hybrid's {"ssm": [an SSMCache per SSM layer],
    "shared": [a KVCache per application of the shared block]}."""
    if cfg.arch_type != "hybrid":
        return {"layers": list(caches)}
    pairs = list(zip(kinds, caches))
    return {"ssm": [c for k, c in pairs if k == "ssm"],
            "shared": [c for k, c in pairs if k == "dense"]}


def _schedule_caches(cfg: ModelConfig, kinds, state: dict) -> list:
    """The serve state's caches in `_schedule`'s order."""
    if cfg.arch_type != "hybrid":
        return state["layers"]
    ssm, shared = iter(state["ssm"]), iter(state["shared"])
    return [next(ssm) if k == "ssm" else next(shared) for k in kinds]


def _decoder_only_forward(params: LM, cfg: ModelConfig, x, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in _schedule(params, cfg):
        x, a = blk.block_forward(lp, cfg, x, positions, kind)
        aux = aux + a
    return x, aux


def encode(params: LM, cfg: ModelConfig, encoder_embeds: torch.Tensor):
    """The enc-dec encoder over frame embeddings (B, S_enc, d): dense
    blocks without the causal mask, then enc_norm. Returns (memory, aux)."""
    x = encoder_embeds.to(cfg.dtype)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.encoder:
        x, a = blk.block_forward(lp, cfg, x, pos, "dense", causal=False)
        aux = aux + a
    return rms_norm(x, params.enc_norm, cfg.norm_eps), aux


def _encdec_forward(params: LM, cfg: ModelConfig, batch: dict):
    memory, aux = encode(params, cfg, batch["encoder_embeds"])
    x = F.embedding(batch["tokens"], params.embed)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp in params.decoder:
        mk, mv = blk.cross_memory_kv(lp.cross_attn, memory)
        x, a = blk.cross_block_forward(lp, cfg, x, pos, mk, mv)
        aux = aux + a
    return x, aux


def _hidden(params: LM, cfg: ModelConfig, batch: dict):
    """The last layer's output over the text positions (B, S, d), and
    aux."""
    if cfg.is_encdec:
        return _encdec_forward(params, cfg, batch)
    x, positions, offset = _embed_inputs(params, cfg, batch)
    x, aux = _decoder_only_forward(params, cfg, x, positions)
    return x[:, offset:], aux


def forward(params: LM, cfg: ModelConfig, batch: dict):
    """-> (logits over the padded vocab aligned with batch['tokens'], aux).
    A VLM's prefix rows get no logits (the reference slices them off)."""
    check_ported(cfg)
    x, aux = _hidden(params, cfg, batch)
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
    """Empty caches for decode from scratch: {"layers": [a KVCache (GQA),
    MLACache or SSMCache per layer]}, a hybrid's {"ssm": [an SSMCache per
    SSM layer], "shared": [a KVCache per application of the shared
    block]}, or an enc-dec model's {"self": [a KVCache per decoder layer],
    "cross_k": [...], "cross_v": [(B, enc_len, KV, Dh) zeros per decoder
    layer]} (the reference stacks them along leading layer axes)."""
    check_ported(cfg)
    dev = init_device(None, device)
    dtype = dtype or cfg.dtype
    if cfg.is_encdec:
        L = cfg.num_layers
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {
            "self": [blk.attn_empty_cache(cfg, batch, cache_len, dtype, dev)
                     for _ in range(L)],
            "cross_k": [torch.zeros(shape, dtype=dtype, device=dev)
                        for _ in range(L)],
            "cross_v": [torch.zeros(shape, dtype=dtype, device=dev)
                        for _ in range(L)],
        }
    if cfg.arch_type == "hybrid":
        kinds = ["ssm"] * cfg.num_layers + ["dense"] * (
            cfg.num_layers // cfg.shared_attn_every)
    else:
        kinds = [layer_kind(cfg)] * cfg.num_layers
    return _serve_state(cfg, kinds, [
        blk.block_empty_cache(cfg, k, batch, cache_len, dtype, dev)
        for k in kinds])


@torch.inference_mode()
def decode_step(params: LM, cfg: ModelConfig, token: torch.Tensor,
                state: dict, position: int):
    """token: (B, 1) ints -> (logits (B, 1, Vp), state). The caches of
    `state` are updated in place and returned in it."""
    check_ported(cfg)
    x = F.embedding(token, params.embed)
    if cfg.is_encdec:
        caches = []
        for lp, cache, mk, mv in zip(params.decoder, state["self"],
                                     state["cross_k"], state["cross_v"]):
            x, cache = blk.cross_block_decode(lp, cfg, x, cache, position,
                                              mk, mv)
            caches.append(cache)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        return x @ params.lm_head, dict(state, self=caches)
    schedule = _schedule(params, cfg)
    kinds = [k for _, k in schedule]
    caches = []
    for (lp, kind), cache in zip(schedule,
                                 _schedule_caches(cfg, kinds, state)):
        x, cache = blk.block_decode(lp, cfg, x, None, kind, cache, position)
        caches.append(cache)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, _serve_state(cfg, kinds, caches)


@torch.inference_mode()
def prefill(params: LM, cfg: ModelConfig, batch: dict):
    """Full-sequence pass returning last-position logits (B, 1, Vp)."""
    check_ported(cfg)
    x, _ = _hidden(params, cfg, batch)
    # rms_norm and the head act on each position alone: the last position's
    # logits need neither the other positions nor an (S, Vp) product
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return x @ params.lm_head


@torch.inference_mode()
def prefill_with_state(params: LM, cfg: ModelConfig, batch: dict,
                       cache_len: int):
    """One full-sequence pass that also builds the decode caches — the
    production prefill path. Decoder-only architectures; a VLM's caches
    hold its prefix rows before the text's. Enc-dec models prefill in the
    engine (`serve.engine._fill_cross_memory`, then the prompt replayed
    through decode_step). Returns (last-position logits, serve state)."""
    check_ported(cfg)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an enc-dec prefill is the engine's "
                         "(its cross memory, then the prompt replayed "
                         "through decode_step)")
    x, positions, _ = _embed_inputs(params, cfg, batch)
    schedule = _schedule(params, cfg)
    caches = []
    for lp, kind in schedule:
        x, _, cache = blk.block_forward(lp, cfg, x, positions, kind,
                                        cache_len=cache_len)
        caches.append(cache)
    # the head on the last position only: the same logits as the
    # reference's (x @ lm_head)[:, -1:], without an (S, Vp) product
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, _serve_state(cfg, [k for _, k in schedule],
                                            caches)
