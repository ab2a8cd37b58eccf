"""What every loop kind shares.

A loop holds one cell's state and is driven by the harness: ``setup``
once, then per call ``make_input(index)``, ``call(x)`` (dispatch, until
the call returns), ``finish()`` (until the device is done), ``keep`` /
``drop``; after the window ``release`` and ``check``, which returns the
numbers held against ``limits/<cell>.json``.  Inputs follow from the seed
and the index alone, so the check makes them again.
"""

from __future__ import annotations

import torch

from .. import common

#: Steps a training loop records in set-up for its check.
RECORDED_STEPS = 3


class Loop:
    window_offset = 0  # the data index of the window's first call

    def __init__(self, config: dict, mix: dict, backend, device, seed: int) -> None:
        self.config, self.mix, self.backend = config, mix, backend
        self.device, self.seed = device, seed
        self.shape = (mix["batch"], *config["shape"])
        self.ndim = len(config["shape"])
        self.elements_per_call = common.numel(self.shape)
        self.detail = None  # what the check read, for standard error

    def make_input(self, index: int) -> torch.Tensor:
        return common.normal(self.shape, self.device, self.seed, common.INPUT, index)

    def keep(self, index: int) -> None:
        """The harness drew this call for the check."""

    def drop(self) -> None:
        """The harness is done with this call's outputs."""

    def release(self) -> None:
        """Free the program's state before the check."""


def first_gradient(opt: torch.optim.Optimizer, param: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """The gradient the optimizer took in its first step, from its state:
    Adam's first moment over ``1 - beta1``, or SGD's step over its rate."""
    group = next(g for g in opt.param_groups if any(p is param for p in g["params"]))
    if isinstance(opt, torch.optim.Adam):
        return opt.state[param]["exp_avg"].double() / (1.0 - group["betas"][0])
    if isinstance(opt, torch.optim.SGD) and not group["momentum"] and not group["weight_decay"]:
        return (before.double() - param.detach().double()) / group["lr"]
    raise TypeError(f"no first gradient for {type(opt).__name__}")


class TrainLoop(Loop):
    """A training step per call: ``loss(x)``, backward, the optimizer's
    step, ending in ``loss.item()`` as a logging training loop's does.

    Set-up drives the loop's one training object through its first
    ``RECORDED_STEPS`` steps by the window's own call, each on a batch of
    its own, and records each step's loss, the first gradient as the
    optimizer holds it, and every parameter's change; the same object then
    runs the window, and the reference follows the recorded steps.
    """

    window_offset = RECORDED_STEPS

    def call(self, x) -> None:
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(x)
        loss.backward()
        self.opt.step()
        self.pending = loss

    def finish(self) -> None:
        self.value = self.pending.item()
        self.pending = None

    def record(self, params: dict) -> dict:
        """``{"losses", "grad", "change"}`` of the recorded steps, norms by
        parameter name."""
        start = {name: p.detach().clone() for name, p in params.items()}
        losses, grad = [], {}
        for k in range(RECORDED_STEPS):
            self.call(self.make_input(k))
            self.finish()
            losses.append(self.value)
            if k == 0:
                grad = {n: float(first_gradient(self.opt, p, start[n]).norm()) for n, p in params.items()}
        change = {n: float((p.detach().double() - start[n].double()).norm()) for n, p in params.items()}
        return {"losses": losses, "grad": grad, "change": change}

    def release(self) -> None:
        self.opt = None
