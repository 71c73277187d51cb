"""The comparisons that decide ``correct``, each number against its limit.

Serving (every answer of a sample of the requests completed in the window,
drawn from the seed, the request with the most persons always in it):

* ``conf_gap``: the widest gap between a served joint's confidence and the
  reference's heatmap peak, over the sample's largest reference peak. A
  peak moves no more than the heatmap does, so this holds the heatmaps.
* ``conf_rms``: the root mean square of the same gaps over every joint of
  the sample, over the same peak: steady from seed to seed where the
  widest gap is set by a few sensitive joints.
* ``pos_gap_px``: the widest distance, in heatmap pixels, between a served
  joint and the reference's, over the joints whose position the heatmaps
  determine: a peak positive, inside the map, unambiguous (nothing farther
  than ``PEAK_RADIUS`` pixels comes within the cell's ``peak_margin`` of the
  sample's largest peak below it) and a DARK step of at most ``MAX_STEP``
  pixels. On
  random weights a near-singular Hessian makes DARK's step unbounded, and a
  second peak within rounding of the first makes the argmax a coin toss;
  both are properties of the inputs, read off the reference alone. The share
  of joints held is printed beside it.

Training (the first three steps, which set-up runs through the window's own
call on three different batches; the reference follows them from the same
weights, batches and dropout seeds):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the widest gap between the norms of a tensor's first
  gradient (as Adam holds it after one step), over the larger of the
  reference's norm of that tensor and of the median tensor;
* ``change_gap``: the same of each tensor's change after the three steps,
  over the elements whose first reference gradient is at least a thousandth
  of the median tensor's root mean square: the others (the key bias under
  softmax, in the packed q, k, v bias) move by round-off alone under Adam.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

#: margins whose held share and widest distance a run prints beside the cell's
DIAGNOSTIC_MARGINS = (0.01, 0.02, 0.04)
MAX_STEP = 1.0
SMALL_GRAD = 1e-3


def serve_numbers(served: List[np.ndarray], answers: List[Dict],
                  margin: float) -> Dict[str, float]:
    """``served``: the [n, K, 3] keypoints each sampled request got; ``answers``:
    the reference's :func:`~bench_h100.reference.serve.answer` of each;
    ``margin``: the cell's peak margin, a share of the sample's largest peak."""
    scale = max(float(a["peak"].abs().max()) for a in answers)
    conf, squares = 0.0, 0.0
    margins = {m: [0, 0.0] for m in DIAGNOSTIC_MARGINS + (margin,)}
    total = 0
    for kp, a in zip(served, answers):
        kp = torch.as_tensor(np.asarray(kp), dtype=torch.float32, device=a["peak"].device)
        if kp.shape[:2] != a["peak"].shape or not torch.isfinite(kp[..., 2]).all():
            return {"conf_gap": math.inf, "conf_rms": math.inf, "pos_gap_px": math.inf,
                    "held_share": 0.0, "by_margin": {}}
        gap = (kp[..., 2] - a["peak"]).abs() / scale
        conf = max(conf, float(gap.max()))
        squares += float(gap.double().pow(2).sum())
        posed = (a["peak"] > 0) & a["interior"] & (a["offset"].abs().amax(-1) <= MAX_STEP)
        dist = (kp[..., :2] - a["coords"]).norm(dim=-1) / a["px"][:, None]
        dist = torch.where(torch.isfinite(dist), dist, math.inf)
        for m, acc in margins.items():
            ok = posed & (a["peak"] - a["runner_up"] >= m * scale)
            acc[0] += int(ok.sum())
            if ok.any():
                acc[1] = max(acc[1], float(dist[ok].max()))
        total += posed.numel()
    held, pos = margins[margin]
    return {"conf_gap": conf, "conf_rms": math.sqrt(squares / max(total, 1)), "pos_gap_px": pos,
            "held_share": held / max(total, 1),
            "by_margin": {str(m): [acc[0] / max(total, 1), acc[1]] for m, acc in margins.items()}}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def norm_gap(got: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (three), ``grad`` (first gradients
    by name) and ``change`` (by name) of the program and the reference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss = math.inf
    g_ref, g_prog = _norms(ref["grad"]), _norms(prog["grad"])
    names = sorted(g_ref)  # a tensor the program gave no gradient reads 0
    g_prog = {k: g_prog.get(k, 0.0) for k in names}
    # elements whose reference gradient is under SMALL_GRAD of the median
    # tensor's root mean square move by round-off alone under Adam
    rms = {k: float(v.double().pow(2).mean().sqrt()) for k, v in ref["grad"].items()}
    floor = SMALL_GRAD * float(np.median(list(rms.values())))
    held = {k: ref["grad"][k].abs() >= floor for k in names}
    moved = [k for k in names if held[k].any()]
    c_ref = {k: float(ref["change"][k][held[k]].double().norm()) for k in moved}
    c_prog = {k: float(prog["change"][k][held[k]].double().norm()) for k in moved}
    return {"loss_gap": loss, "grad_gap": norm_gap(g_prog, g_ref, names),
            "change_gap": norm_gap(c_prog, c_ref, moved),
            "left_out": float(sum(int((~held[k]).sum()) for k in names))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every limited number within its limit."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, compared
