"""Batched serving engine: prefill once, then decode — greedy argmax or
temperature sampling per `ServeConfig`.

Port of `repro/serve/engine.py`. A host-side loop over
`model.prefill_with_state` (whose attention is the flash kernel on the
card) and `model.decode_step`, under `torch.inference_mode()`. Tokens stay
on the model's device until the end, so the loop never waits on the card.
Sampling draws from a `torch.Generator`; the reference draws from
`jax.random`, so sampled tokens differ between the two by design (greedy
tokens agree).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.common import LATER_ARCHS, ModelConfig


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
    (`models.model.LM`); the engine runs on its device. The reference's
    `extra_batch` (enc-dec encoder embeddings, VLM prefixes) has no
    counterpart: those models are not ported."""

    def __init__(self, cfg: ModelConfig, params: model_lib.LM,
                 serve_cfg: ServeConfig):
        if cfg.is_encdec:
            raise NotImplementedError("the enc-dec engine path (the "
                                      "reference's _fill_cross_memory) is "
                                      f"not ported: {LATER_ARCHS['encdec']}")
        model_lib.check_ported(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = params.embed.device

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
        # one full-sequence pass builds the decode caches
        logits, state = model_lib.prefill_with_state(
            self.params, self.cfg, {"tokens": prompts}, self.scfg.cache_len)
        pos = prompts.shape[1]
        token = self._select(logits[:, -1:, :], generator)
        out = [token]
        for i in range(self.scfg.max_new_tokens - 1):
            logits, state = model_lib.decode_step(self.params, self.cfg,
                                                  token, state, pos + i)
            token = self._select(logits, generator)
            out.append(token)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
