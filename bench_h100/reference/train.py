"""The reference's training steps: crops, box masks and targets from a raw
batch, the forward in training mode with the step's dropout, the masked
heatmap MSE, and Adam.

Loss (reference ``lib/core/loss.py``, under the person mask): the mean over
joints of half the squared error of target-weighted heatmaps, summed over
the valid persons and pixels and divided by their count. Adam: betas (0.9,
0.999), eps 1e-8, no weight decay, bias-corrected.
"""

from __future__ import annotations

import torch

from bench_h100.reference.geometry import box_masks, crops, targets
from bench_h100.reference.nets import Net, exact_f32

BETAS = (0.9, 0.999)
EPS = 1e-8


def _invert(aff: torch.Tensor) -> torch.Tensor:
    a, t = aff[..., :2], aff[..., 2:]
    ai = torch.linalg.inv(a)
    return torch.cat([ai, -ai @ t], dim=-1)


def model_inputs(raw, cfg, device):
    """A raw host batch -> (crops [B, N, h, w, 3], box masks, target, target
    weight, valid) on ``device``, recomputed from the images and affines."""
    m = cfg["MODEL"]
    iw, ih = m["IMAGE_SIZE"]
    images = torch.as_tensor(raw["images"], device=device)
    aff = torch.as_tensor(raw["crop_affines"], dtype=torch.float64, device=device)
    maff = torch.as_tensor(raw["mask_affines"], dtype=torch.float64, device=device)
    b, n = aff.shape[:2]
    inv, minv = _invert(aff).float(), _invert(maff).float()
    ramps = torch.as_tensor(raw["boxes"], device=device)
    x = torch.stack([crops(images[i], inv[i], iw, ih) for i in range(b)])
    pm = box_masks(ramps.reshape(b * n, 4), minv.reshape(b * n, 2, 3), iw, ih)
    valid = torch.as_tensor(raw["person_valid"], device=device)
    tgt, tw = targets(torch.as_tensor(raw["joints_hm"], device=device),
                      torch.as_tensor(raw["joints_vis"], device=device),
                      m["HEATMAP_SIZE"], m["SIGMA"])
    return x, pm.reshape(b, n, ih, iw, 1), tgt, tw, valid


def mse(heat, target, weight, valid):
    k, hw = heat.shape[2], heat.shape[3] * heat.shape[4]
    pred = heat.reshape(*heat.shape[:3], hw) * weight[..., None]
    gt = target.reshape(*heat.shape[:3], hw) * weight[..., None]
    sq = ((pred - gt) ** 2) * valid[:, :, None, None].float()
    rows = torch.clamp(valid.sum().float() * hw, min=1.0)
    return 0.5 * (sq.sum((0, 1, 3)) / rows).mean()


def train_steps(params0, cfg, raws, seeds, device, quant=None, rate=0.1):
    """``len(seeds)`` Adam steps from ``params0`` (trainable tensors by name,
    and the BatchNorms' running statistics, unused in training) on ``raws``
    -> (losses, the first step's gradients by name of the tensors that got
    one, each trained tensor's change after the last step)."""
    lr = float(cfg["TRAIN"]["LR"])
    names = [k for k in params0 if not k.endswith(("running_mean", "running_var"))]
    params = {k: v.clone() for k, v in params0.items()}
    state = {k: (torch.zeros_like(params[k]), torch.zeros_like(params[k])) for k in names}
    losses, first = [], None
    use_weight = cfg["LOSS"]["USE_TARGET_WEIGHT"]
    with exact_f32():
        for t, (raw, seed) in enumerate(zip(raws, seeds), start=1):
            leaves = {k: params[k].requires_grad_(True) for k in names}
            net = Net({**params, **leaves}, cfg, quant)
            net.train, net.seed, net.rate = True, int(seed), rate
            x, pm, tgt, tw, valid = model_inputs(raw, cfg, device)
            heat = net(x, pm, valid)
            vf = valid.float()
            loss = mse(heat, tgt * vf[:, :, None, None, None],
                       tw * vf[:, :, None] if use_weight else torch.ones_like(tw), valid)
            # the tensors no output depends on (the last fusion's paths to the
            # branches the head never reads) get no gradient, and Adam skips them
            grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            losses.append(float(loss))
            del heat, x, pm, tgt, loss, net
            with torch.no_grad():
                if first is None:
                    first = {k: g.clone() for k, g in zip(names, grads) if g is not None}
                for k, g in zip(names, grads):
                    if g is None:
                        params[k] = params[k].detach()
                        continue
                    m1, m2 = state[k]
                    m1.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    m2.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = (m2 / (1 - BETAS[1] ** t)).sqrt_().add_(EPS)
                    params[k] = params[k].detach() - lr / (1 - BETAS[0] ** t) * m1 / denom
            del grads
    change = {k: params[k] - params0[k] for k in names}
    return losses, first, change
