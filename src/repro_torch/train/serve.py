"""Serving-step builders: prefill, decode and greedy generation.

Port of `repro.train.serve`.  The decode state (KV caches, Mamba conv
windows and SSM states, RWKV shifts and WKV states) is updated in
place.  On a CUDA device ``greedy_generate`` replays its decode step as
a CUDA graph (``GraphedDecode``): a decode step is some 4,000 small
PyTorch ops for internlm2-1.8b, and launching them from the host costs
more than the card's work.  The graph runs the same kernels on the same
buffers, so the numbers are the eager step's.  The encoder-decoder is
served through ``prefill_fn`` and ``decode_fn`` with ``batch["memory"]``;
``greedy_generate`` has no encoder-decoder branch, as in the reference.
With a mesh, the prefill and decode steps run on DTensor parameters,
batch and decode state (`dist.sharding.shard_put`, ``shard_state``).
"""
from __future__ import annotations

import torch

from repro_torch.models import model_zoo


def build_prefill_step(cfg, mesh=None):
    """``prefill_step(params, batch)``; with ``mesh`` on DTensors."""
    def prefill_step(params, batch):
        return model_zoo.prefill_fn(cfg, params, batch, mesh=mesh)

    return prefill_step


def build_decode_step(cfg, mesh=None):
    """``decode_step(params, state, batch, pos)``; with ``mesh`` on
    DTensors, the state placed by `dist.sharding.shard_state`."""
    def decode_step(params, state, batch, pos):
        return model_zoo.decode_fn(cfg, params, state, batch, pos, mesh=mesh)

    return decode_step


class GraphedDecode:
    """The decode step of one (params, state) pair, as a callable
    ``(tokens [B, 1], pos: int) -> logits [B, padded_vocab]``.

    On a CUDA device the first call runs the step eagerly on a side stream
    (it warms the libraries and writes that step's K/V) and captures it as
    a CUDA graph; each later call copies the token and the position into
    the captured inputs and replays the graph.  The returned logits are
    the graph's output buffer, overwritten by the next call.  The state is
    updated in place by every call, as by ``decode_fn``.  On the CPU each
    call is ``decode_fn``.
    """

    def __init__(self, cfg, params, state):
        self.cfg, self.params, self.state = cfg, params, state
        self.graph = None

    def _step(self, tokens, pos):
        return model_zoo.decode_fn(self.cfg, self.params, self.state,
                                   {"tokens": tokens}, pos)[0]

    def __call__(self, tokens, pos: int):
        if tokens.device.type != "cuda":
            return self._step(tokens, pos)
        if self.graph is None:
            self.tokens = tokens.clone()
            self.pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
            side = torch.cuda.Stream(device=tokens.device)
            side.wait_stream(torch.cuda.current_stream(tokens.device))
            with torch.cuda.stream(side):
                logits = self._step(self.tokens, self.pos)
            torch.cuda.current_stream(tokens.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = self._step(self.tokens, self.pos)
            return logits
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits


def greedy_generate(cfg, params, prompt_tokens, *, steps: int, max_len: int):
    """Greedy decoding: feeds the prompt a token at a time through the
    decode step, then takes ``steps`` argmax tokens (over the padded vocab,
    as the reference does).  Returns [B, 1 + steps]: the first prompt token
    and the generated ones."""
    b, s0 = prompt_tokens.shape
    state = model_zoo.decode_state_init(cfg, b, max_len,
                                        device=prompt_tokens.device)
    decode = GraphedDecode(cfg, params, state)
    out = [prompt_tokens[:, :1]]
    pos = 0
    for i in range(s0 - 1):
        decode(prompt_tokens[:, i: i + 1], pos)
        pos += 1
    tok = prompt_tokens[:, s0 - 1: s0]
    for _ in range(steps):
        logits = decode(tok, pos)
        pos += 1
        tok = torch.argmax(logits, dim=-1)[:, None].to(prompt_tokens.dtype)
        out.append(tok)
    return torch.cat(out, dim=1)
