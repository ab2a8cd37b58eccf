"""The comparisons that decide ``correct``: the program's outputs of the
timed path against the plain reference, in float64, in blocks of items.

Every number is a relative gap (0 = equal); each is held against its own
limit in ``limits/<cell>.json``.  The reference makes everything it uses
from the seeded inputs the harness hands it and from its own frozen taps;
it reads the program's outputs only to judge them.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import bank_losses, dwt

_F64 = torch.float64


def _crop(t: torch.Tensor, shape) -> torch.Tensor:
    return t[(Ellipsis, *(slice(0, n) for n in shape))]


def _details(coeffs, ndim: int) -> list:
    return list(coeffs[1:]) if ndim == 1 else [b for triple in coeffs[1:] for b in triple]


def roundtrip(x: torch.Tensor, coeffs, rec: torch.Tensor, config: dict, block: int) -> dict:
    """``bands``: the largest gap of any band of the program's analysis
    over that band's largest magnitude in the reference; ``recon``: the
    largest gap of the program's reconstruction over the input's largest
    magnitude."""
    ndim, shape = len(config["shape"]), config["shape"]
    filters = dwt.bank(config["wavelet"], _F64, x.device)
    got = dwt.bands(coeffs, ndim)
    gaps, peaks = [0.0] * len(got), [0.0] * len(got)
    rec_gap = x_peak = 0.0
    for s in range(0, x.shape[0], block):
        xb = x[s : s + block].to(_F64)
        want = dwt.bands(dwt.wavedec(xb, filters, config["mode"], config["level"], ndim), ndim)
        if len(want) != len(got):
            return {"bands": math.inf, "recon": math.inf}
        for j, (g, w) in enumerate(zip(got, want)):
            g = g[s : s + block]
            if g.shape != w.shape:
                return {"bands": math.inf, "recon": math.inf}
            gaps[j] = max(gaps[j], float((g.to(_F64) - w).abs().max()))
            peaks[j] = max(peaks[j], float(w.abs().max()))
        r = rec[s : s + block]
        if tuple(r.shape[-ndim:]) < tuple(shape) or r.shape[0] != xb.shape[0]:
            return {"bands": max(g / p for g, p in zip(gaps, peaks)), "recon": math.inf}
        rec_gap = max(rec_gap, float((_crop(r, shape).to(_F64) - xb).abs().max()))
        x_peak = max(x_peak, float(xb.abs().max()))
    return {"bands": max(g / p for g, p in zip(gaps, peaks)), "recon": rec_gap / x_peak}


def _level_sum(coeffs, ndim: int, fn) -> torch.Tensor:
    return sum(fn(d) for d in _details(coeffs, ndim))


def gain_steps(u0: torch.Tensor, targets, config: dict, mix: dict, steps: int) -> dict:
    """The reference of ``loops/gain_train.py``: ``steps`` SGD steps from
    ``u0`` and unit gains, on ``targets(k)``."""
    ndim, shape, block = len(config["shape"]), config["shape"], mix["reference_block"]
    filters = dwt.bank(config["wavelet"], _F64, u0.device)
    u = u0.to(_F64)
    g = torch.ones(config["level"], 3 if ndim == 2 else 1, dtype=_F64, device=u.device)
    n_total = u.numel()
    lr_u, lr_g = mix["lr_u_per_element"] * n_total, mix["lr_g"]
    losses, first = [], None
    for k in range(steps):
        y = targets(k)
        grad_u, grad_g, loss = torch.empty_like(u), torch.zeros_like(g), 0.0
        count = None
        for s in range(0, u.shape[0], block):
            ub = u[s : s + block].clone().requires_grad_(True)
            gg = g.clone().requires_grad_(True)
            coeffs = dwt.wavedec(ub, filters, config["mode"], config["level"], ndim)
            if ndim == 2:
                scaled = [tuple(gg[lev, o] * d for o, d in enumerate(t)) for lev, t in enumerate(coeffs[1:])]
            else:
                scaled = [gg[lev, 0] * d for lev, d in enumerate(coeffs[1:])]
            rec = _crop(dwt.waverec((coeffs[0], *scaled), filters, ndim), shape)
            if count is None:
                count = sum(d.numel() for d in _details(coeffs, ndim)) * u.shape[0] // ub.shape[0]
            energy = _level_sum(coeffs, ndim, lambda d: (d**2).sum())
            part = ((rec - y[s : s + block].to(_F64)) ** 2).sum() / n_total + mix["energy_weight"] * energy / count
            gu, gg_grad = torch.autograd.grad(part, (ub, gg))
            grad_u[s : s + block] = gu
            grad_g += gg_grad
            loss += float(part.detach())
        losses.append(loss)
        if first is None:
            first = {"u": float(grad_u.norm()), "g": float(grad_g.norm())}
        u -= lr_u * grad_u
        g -= lr_g * grad_g
    change = {"u": float((u - u0.to(_F64)).norm()), "g": float((g - 1.0).norm())}
    return {"losses": losses, "grad": first, "change": change}


def initial_bank(config: dict, mix: dict, seed: int, device) -> list:
    """The learnable bank's start, handed to the program and to the
    reference alike: the frozen taps plus seeded normal noise of
    ``mix["init_noise"]`` on every tap (float64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    return [f + mix["init_noise"] * torch.randn(f.shape, generator=gen, dtype=_F64, device=device)
            for f in dwt.bank(config["wavelet"], _F64, device)]


def learn_steps(start: list, inputs, config: dict, mix: dict, steps: int) -> dict:
    """The reference of ``loops/learn_bank.py``: ``steps`` Adam steps of
    the bank from ``start``, on ``inputs(k)``."""
    ndim, shape, block = len(config["shape"]), config["shape"], mix["reference_block"]
    names = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")
    params = [f.to(_F64).clone() for f in start]
    start = [p.clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    beta1, beta2, eps, lr = 0.9, 0.999, 1e-8, mix["adam_lr"]
    losses, first = [], None
    for k in range(steps):
        x = inputs(k)
        leaves = [p.clone().requires_grad_(True) for p in params]
        grads = [torch.zeros_like(p) for p in params]
        loss, counts = 0.0, None
        for s in range(0, x.shape[0], block):
            xb = x[s : s + block].to(_F64)
            coeffs = dwt.wavedec(xb, leaves, config["mode"], config["level"], ndim)
            rec = _crop(dwt.waverec(coeffs, leaves, ndim), shape)
            details = _details(coeffs, ndim)
            if counts is None:
                counts = [d.numel() * x.shape[0] // xb.shape[0] for d in details]
            sparsity = sum(d.abs().sum() / c for d, c in zip(details, counts))
            fidelity = ((rec - xb) ** 2).sum() / x.numel()
            part = mix["sparsity_weight"] * sparsity + mix["fidelity_weight"] * fidelity
            for acc, gr in zip(grads, torch.autograd.grad(part, leaves)):
                acc += gr
            loss += float(part.detach())
        quality = mix["quality_weight"] * bank_losses.wavelet_loss(*leaves)
        for acc, gr in zip(grads, torch.autograd.grad(quality, leaves)):
            acc += gr
        losses.append(loss + float(quality.detach()))
        if first is None:
            first = {n: float(gr.norm()) for n, gr in zip(names, grads)}
        t = k + 1
        for p, gr, mk, vk in zip(params, grads, m, v):
            mk.mul_(beta1).add_(gr, alpha=1 - beta1)
            vk.mul_(beta2).addcmul_(gr, gr, value=1 - beta2)
            denom = vk.sqrt() / math.sqrt(1 - beta2**t) + eps
            p.addcdiv_(mk, denom, value=-lr / (1 - beta1**t))
    change = {n: float((p - p0).norm()) for n, p, p0 in zip(names, params, start)}
    return {"losses": losses, "grad": first, "change": change}


#: A leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by round-off alone: left out of ``change``.
STILL_LEAF = 1e-3


def _worst_leaf(got: dict, want: dict, names) -> float:
    scale = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], scale) for n in names)


def compare_training(got: dict, want: dict) -> dict:
    """``loss``: the largest relative gap of a recorded step's loss, and
    ``loss_first`` of the first step's; ``grad``: by the worst leaf, the
    gap of the first gradient's norms over the reference's norm of that
    leaf or of the median leaf, whichever is larger; ``change``: the same
    of the parameters' change over the recorded steps, leaving out leaves
    whose reference gradient is under ``STILL_LEAF`` of the median leaf's.
    """
    gaps = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
    names = list(want["grad"])
    median = statistics.median(want["grad"].values())
    moving = [n for n in names if want["grad"][n] >= STILL_LEAF * median]
    return {
        "loss": max(gaps),
        "loss_first": gaps[0],
        "grad": _worst_leaf(got["grad"], want["grad"], names),
        "change": _worst_leaf(got["change"], want["change"], moving),
    }
