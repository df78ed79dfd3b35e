"""The training step of the port: the causal LM loss with the experts'
auxiliary loss, over layers that may run under activation checkpointing
(``remat``), and AdamW — the JAX package's ``training/train_step.py`` on
tensors. The gradients come from ``torch.autograd``: through
``flash_vjp``'s Function at every attention (the hand-written backward on
a GPU), plain autograd elsewhere.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.registry import ModelAPI
from repro_torch.training.optimizer import (AdamW, AdamWState, flatten,
                                            unflatten)


def _chunked_ce(logits, labels, n_chunks: int = 16):
    """Mean cross-entropy over the labels >= 0, with the float32
    log-softmax made one sequence chunk at a time under checkpoint, so no
    float32 (B, S, V) buffer is held (about 10 GB at qwen2-0.5b's 8 x 2048
    x 151,936). ``n_chunks`` halves until it divides S."""
    b, s, v = logits.shape
    while s % n_chunks:
        n_chunks //= 2
    cs = s // n_chunks

    def chunk(lg, lb):
        logp = F.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, lb.clamp(min=0)[..., None])[..., 0]
        mask = (lb >= 0).float()
        return (nll * mask).sum(), mask.sum()

    nll_sum = cnt = 0.0
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        n, c = torch.utils.checkpoint.checkpoint(
            chunk, logits[:, sl], labels[:, sl], use_reentrant=False)
        nll_sum = nll_sum + n
        cnt = cnt + c
    return nll_sum / torch.clamp(cnt, min=1.0)


def lm_loss(api: ModelAPI, params, batch, *, remat: bool = True,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """(loss + aux_weight * load-balance loss, {"loss", "aux_loss",
    "dropped_fraction"})."""
    logits, aux = api.forward(params, batch, remat=remat)
    loss = _chunked_ce(logits, batch["labels"])
    total = loss + aux_weight * aux["load_balance_loss"]
    metrics = {"loss": loss, "aux_loss": aux["load_balance_loss"],
               "dropped_fraction": aux["dropped_fraction"]}
    return total, metrics


def loss_and_grads(api: ModelAPI, params, batch, *, remat: bool = True,
                   aux_weight: float = 0.01):
    """(metrics, grads): the gradients of ``lm_loss``'s total over every
    parameter leaf (which must require grad), as a tree of the parameters'
    layout; a leaf the loss does not reach gets zeros."""
    total, metrics = lm_loss(api, params, batch, remat=remat,
                             aux_weight=aux_weight)
    leaves = flatten(params)
    grads = torch.autograd.grad(total, [x for _, x in leaves],
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for (_, x), g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, unflatten((path, g) for (path, _), g in zip(leaves,
                                                                grads))


def make_train_step(api: ModelAPI, opt: AdamW, *, remat: bool = True,
                    aux_weight: float = 0.01):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics); the parameters are updated in place (``AdamW.update``)."""

    def train_step(params, opt_state: AdamWState, batch):
        metrics, grads = loss_and_grads(api, params, batch, remat=remat,
                                        aux_weight=aux_weight)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(api: ModelAPI):
    """Returns eval_step(params, batch) -> metrics, without gradients."""

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm_loss(api, params, batch, remat=False)
        return metrics

    return eval_step
