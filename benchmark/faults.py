"""Faults planted in the program, to show that the comparison catches
them: each is a context manager that patches one function of the timed
path and restores it on exit. Used by the CPU tests and, for the training
cell's faults, by ``control.py`` on the chip."""

from __future__ import annotations

import contextlib

from .weights import leaves


@contextlib.contextmanager
def _patched(obj, name: str, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def token_altered():
    """Every streamed token is another id than the engine produced."""
    from macaw_llm_tpu_torch import serve
    return _patched(serve, "_emit", lambda old: (
        lambda req, tok: old(req, (int(tok) + 1) % 32000 + 16)))


def decode_state_unchanged():
    """The decode step computes and then leaves the slots' tokens and
    lengths as they were."""
    from macaw_llm_tpu_torch.serve import ContinuousEngine

    def make(old):
        def step(self):
            toks, lengths = self.toks.clone(), self.lengths.clone()
            old(self)
            self.toks.copy_(toks)
            self.lengths.copy_(lengths)
        return step
    return _patched(ContinuousEngine, "_step", make)


def decode_half_batch():
    """The decode step advances only the first half of the slots."""
    from macaw_llm_tpu_torch.serve import ContinuousEngine

    def make(old):
        def step(self):
            half = self.slots // 2
            toks = self.toks[half:].clone()
            lengths = self.lengths[half:].clone()
            old(self)
            self.toks[half:] = toks
            self.lengths[half:] = lengths
        return step
    return _patched(ContinuousEngine, "_step", make)


def train_state_unchanged():
    """The optimizer step returns the gradient norm and changes nothing."""
    from macaw_llm_tpu_torch.train.trainer import AdamW

    def make(old):
        def update(self, params, grads, state, g_norm=None):
            import torch
            if g_norm is None:
                g_norm = torch.sqrt(sum((g.float() ** 2).sum()
                                        for g in leaves(grads).values()))
            return g_norm
        return update
    return _patched(AdamW, "update", make)


def train_half_batch():
    """The step takes the loss and gradients over the first half of the
    batch's rows, their mean over that half."""
    from macaw_llm_tpu_torch.train import trainer

    def make(old):
        def train_step(state, batch, *a, **kw):
            half = next(iter(batch.values())).shape[1] // 2
            return old(state, {k: v[:, :half] for k, v in batch.items()},
                       *a, **kw)
        return train_step
    return _patched(trainer, "train_step", make)


SERVE = {"token_altered": token_altered,
         "decode_state_unchanged": decode_state_unchanged,
         "decode_half_batch": decode_half_batch}
TRAIN = {"train_state_unchanged": train_state_unchanged,
         "train_half_batch": train_half_batch}
