"""Batched serving engine: prefill once, then decode — greedy argmax or
temperature sampling per `ServeConfig`.

Port of `repro/serve/engine.py`. A host-side loop over
`model.prefill_with_state` (whose attention is the flash kernel on the
card) and `model.decode_step`, under `torch.inference_mode()`; an enc-dec
model instead encodes once (`_fill_cross_memory`, the flash kernel
without the causal mask) and replays the prompt through decode. Tokens stay
on the model's device until the end, so the loop never waits on the card.
Sampling draws from a `torch.Generator`; the reference draws from
`jax.random`, so sampled tokens differ between the two by design (greedy
tokens agree).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import blocks as blk
from repro_torch.models import model as model_lib
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 16
    cache_len: int = 256
    greedy: bool = True              # argmax decode; False = sample
    temperature: float = 1.0         # sampling softmax temperature

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0.0:
            raise ValueError(
                f"sampling requires temperature > 0, got {self.temperature}"
                " (use greedy=True for argmax decoding)")


class Engine:
    """Minimal batched engine. Prompts are pre-tokenized integer arrays of
    the same length (left-padding is out of scope). `params` is the model
    (`models.model.LM`); the engine runs on its device. `extra_batch`
    holds the stubs' embeddings: an enc-dec model's `encoder_embeds` (B,
    S_enc, d), or a VLM's `prefix_embeds` (B, P, d), moved to the model's
    device."""

    def __init__(self, cfg: ModelConfig, params: model_lib.LM,
                 serve_cfg: ServeConfig, extra_batch: dict | None = None):
        model_lib.check_ported(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = params.embed.device
        self.extra = {k: torch.as_tensor(v, device=self.device)
                      for k, v in (extra_batch or {}).items()}

    def _prefill_state(self, prompts: torch.Tensor):
        """Build the decode caches: one full-sequence pass for a
        decoder-only model (`model.prefill_with_state`); an enc-dec model
        fills its cross memory once, then replays the prompt's tokens
        through decode. Returns (last logits, state, S): the first decode
        step runs at position S, the prompt's length, also where a VLM's
        prefix of P rows precedes it, as in the reference (that step writes
        cache slot S and attends to the slots <= S)."""
        B, S = prompts.shape
        if not self.cfg.is_encdec:
            logits, state = model_lib.prefill_with_state(
                self.params, self.cfg, {"tokens": prompts, **self.extra},
                self.scfg.cache_len)
            return logits, state, S
        memory = self.extra["encoder_embeds"]
        state = model_lib.init_serve_state(
            self.cfg, B, self.scfg.cache_len, enc_len=memory.shape[1],
            device=self.device)
        state = _fill_cross_memory(self.cfg, self.params, state, memory)
        logits = None
        for t in range(S):
            logits, state = model_lib.decode_step(
                self.params, self.cfg, prompts[:, t:t + 1], state, t)
        return logits, state, S

    def _select(self, logits: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        """Next-token choice (B, 1) from (B, 1, V') logits per the
        ServeConfig: greedy argmax, or temperature-scaled categorical
        sampling."""
        logits = logits[:, :, :self.cfg.vocab_size]
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits[:, 0].float() / self.scfg.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    @torch.inference_mode()
    def generate(self, prompts, generator: torch.Generator | None = None
                 ) -> np.ndarray:
        """Decode max_new_tokens continuations -> int32 (B, max_new_tokens).
        `generator` (on the model's device) seeds sampling when
        greedy=False; it defaults to a generator seeded 0, for
        reproducibility, and is ignored for greedy decoding."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                  device=self.device)
        if not self.scfg.greedy and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits, state, pos = self._prefill_state(prompts)
        token = self._select(logits[:, -1:, :], generator)
        out = [token]
        for i in range(self.scfg.max_new_tokens - 1):
            logits, state = model_lib.decode_step(self.params, self.cfg,
                                                  token, state, pos + i)
            token = self._select(logits, generator)
            out.append(token)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


@torch.inference_mode()
def _fill_cross_memory(cfg: ModelConfig, params: model_lib.LM, state: dict,
                       encoder_embeds: torch.Tensor) -> dict:
    """Encode once (`model.encode`: the encoder's flash kernel runs without
    the causal mask, then enc_norm) and project each decoder layer's cross
    k/v into the serve state."""
    memory, _ = model_lib.encode(params, cfg, encoder_embeds)
    kv = [blk.cross_memory_kv(lp.cross_attn, memory) for lp in params.decoder]
    return dict(state, cross_k=[k for k, _ in kv], cross_v=[v for _, v in kv])
