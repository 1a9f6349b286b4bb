"""AdamW with a global-norm clip (port of :mod:`repro.train.optimizer`).

The JAX arithmetic step for step, in f32 whatever the parameters' dtype:
the bias corrections come from an f32 ``step`` (``b1 ** step`` in f32),
each update is ``(p.f32 - lr * delta).to(p.dtype)``.  Not
``torch.optim.AdamW``: its rounding and state layout differ, and this
state checkpoints under the JAX package's keys (``m`` and ``v`` go
through :func:`repro_torch.models.model_zoo.jax_layout`).

``m`` and ``v`` are dicts keyed by the LM's parameter names; :meth:`AdamW.
update` writes the parameters, ``m`` and ``v`` in place.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: dict                     # {parameter name: f32 tensor}
    v: dict


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments for every parameter of ``params`` (the LM)."""
        return self._zeros(params, None)

    def abstract_init(self, params) -> AdamWState:
        """The state's shapes and dtypes on the ``meta`` device (the dry
        run; no allocation)."""
        return self._zeros(params, torch.device("meta"))

    @staticmethod
    def _zeros(params, device) -> AdamWState:
        named = dict(params.named_parameters())
        dev = device or next(iter(named.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros(p.shape, dtype=F32, device=device or p.device)
               for n, p in named.items()},
            v={n: torch.zeros(p.shape, dtype=F32, device=device or p.device)
               for n, p in named.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params) -> tuple[AdamWState, torch.Tensor]:
        """One step from ``grads`` (``{name: gradient}``, any float dtype):
        writes ``params``, ``m`` and ``v`` in place; returns the new state
        and the global gradient norm before the clip."""
        named = dict(params.named_parameters())
        step = state.step + 1
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in
                               grads.values()) + 1e-12)
        scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
        stepf = step.to(F32)
        b1c, b2c = (1.0 - torch.tensor(b, dtype=F32, device=step.device)
                    ** stepf for b in (self.b1, self.b2))
        for name, g in grads.items():
            p, m, v = named[name], state.m[name], state.v[name]
            g = g.float() * scale
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g.square())
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * p.float()
            p.copy_((p.float() - self.lr * delta).to(p.dtype))
        return AdamWState(step=step, m=state.m, v=state.v), gnorm
