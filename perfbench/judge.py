"""The numbers that decide ``correct``, each against its limit.

Frames (``frame_numbers``), one reference frame with its source views: the
program's encodings against the reference's from the same images, and the
program's maps against the reference's fusion run from the program's own
encodings, so that each stage is held by itself (the fusion's consistency
thresholds would otherwise amplify the encoders' rounding):

* ``dnet_rel``: the D-Net decoder feature, mean |diff| over mean |ref|;
* ``head_rel``: the coarse (mu, sigma) of the depth head, rms diff over the
  reference's spread (standard deviation), the worse channel;
* ``fnet_rel``: the F-Net's matching feature, as ``dnet_rel``;
* ``fuse_mu_rel``, ``fuse_sigma_rel``: every iteration's upsampled map, rms
  diff over the reference map's spread, the worst iteration.
* ``head_wit``, ``fuse_mu_wit``, ``fuse_sigma_wit``: ``head_rel``,
  ``fuse_mu_rel`` and ``fuse_sigma_rel`` (the worst over the frames) over
  the same of a witness, the reference in bfloat16 (``precision``), on the
  same frames and, for the fusion, from the same encodings: how far the
  subject lies from float32 in units of what bfloat16 rounding alone gives
  there. A frame's sensitivity to rounding swings from seed to seed (the
  fusion's consistency test flips pixels; a flat map has a small spread),
  and the witness swings with it;
* ``map_mu_rel``, ``map_sigma_rel`` (``map_numbers``): the same of the
  whole pipeline, the maps against the reference's fusion from its own
  encodings; read, and not limited (PERF.md says why).

Training (``train_numbers``), the first steps of one state, or one step
of it drawn from the window (the same numbers with ``win_`` in front):
``loss_gap``, the worst step's |loss - ref| / |ref|; ``cv_gap``, the first
step's softmaxed cost volume as ``dnet_rel``; ``change_gap``, the norm of
each parameter's change over the steps, and ``grad_gap``, the norm of its
first clipped gradient, both by the worst leaf: |norm - ref norm| over the
larger of the reference leaf's norm and the median leaf's (``_leaf`` names
it); ``grad_gap_median``, the median leaf's gap of gradient norms, and
``grad_diff_median``, the median leaf's norm of the gradients' difference
over the same denominator, which sees a gradient wrong in direction as
well as in size. Leaves whose reference gradient is under a thousandth of
the median leaf's (zero but for rounding) are left out of all of them.

``Check(name, value, limit)``: a number passes when it is finite and at
most its limit; a cell's limits file says which numbers are compared.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch

NEGLIGIBLE_GRAD = 1e-3
FRAME_NUMBERS = ("dnet_rel", "head_rel", "fnet_rel", "fuse_mu_rel",
                 "fuse_sigma_rel")


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _pair(p, r):
    r = r.float()
    p = p.float().to(r.device)
    if p.shape != r.shape or not torch.isfinite(p).all():
        return None
    return p, r


def abs_rel(p, r) -> float:
    """mean |p - r| over mean |r|; inf where p cannot be held to r."""
    pr = _pair(p, r)
    if pr is None:
        return math.inf
    p, r = pr
    return float((p - r).abs().mean() / r.abs().mean().clamp(min=1e-30))


def spread_rel(p, r) -> float:
    """rms(p - r) over the standard deviation of r; inf as ``abs_rel``."""
    pr = _pair(p, r)
    if pr is None:
        return math.inf
    p, r = pr
    return float((p - r).pow(2).mean().sqrt() / r.std().clamp(min=1e-30))


def frame_numbers(enc, ref_enc, maps, ref_maps) -> Dict[str, float]:
    """enc, ref_enc: (coarse (mu, sigma), decoder feature, matching
    feature), NCHW, the reference frame first; maps, ref_maps: the
    fusion's upsampled (H, W, 2) maps."""
    gauss, feat_d, feat_m = enc
    r_gauss, r_feat_d, r_feat_m = ref_enc
    out = {"dnet_rel": abs_rel(feat_d, r_feat_d),
           "head_rel": max(spread_rel(gauss[:, c], r_gauss[:, c])
                           for c in range(2)),
           "fnet_rel": abs_rel(feat_m, r_feat_m)}
    for c, ch in enumerate(("mu", "sigma")):
        out[f"fuse_{ch}_rel"] = max(spread_rel(m[..., c], r[..., c])
                                    for m, r in zip(maps, ref_maps,
                                                    strict=True))
    return out


def map_numbers(maps, ref_maps) -> Dict[str, float]:
    """The whole pipeline's gap: ``frame_numbers``' fusion numbers of maps
    against the reference's fusion from its own encodings."""
    return {f"map_{ch}_rel": max(spread_rel(m[..., c], r[..., c])
                                 for m, r in zip(maps, ref_maps, strict=True))
            for c, ch in enumerate(("mu", "sigma"))}


WITNESSED = ("head_rel", "fuse_mu_rel", "fuse_sigma_rel")
WITNESS_NUMBERS = tuple(n[:-len("_rel")] + "_wit" for n in WITNESSED)


def witnessed(worst: Dict[str, float], witness: Dict[str, float]
              ) -> Dict[str, float]:
    """``<name>_wit`` for each of ``WITNESSED`` (``_rel`` dropped): the
    subject's worst over the frames over the witness's."""
    return {w: worst[n] / max(witness[n], 1e-12)
            for n, w in zip(WITNESSED, WITNESS_NUMBERS)}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: List[str]):
    """({leaf: gap of norms}, {leaf: norm of the difference}), each over the
    larger of the reference leaf's norm and the median leaf's."""
    rn = {n: float(ref[n].float().norm()) for n in keep}
    med = float(torch.tensor(list(rn.values())).median())
    gap, diff = {}, {}
    for n in keep:
        p, r = prog[n].float().to(ref[n].device), ref[n].float()
        den = max(rn[n], med, 1e-30)
        gap[n] = abs(float(p.norm()) - rn[n]) / den
        diff[n] = float((p - r).norm()) / den
    return gap, diff


def _median(values) -> float:
    return float(torch.tensor(list(values)).median())


def train_numbers(prog: Dict, ref: Dict) -> Dict:
    """prog, ref: {"losses": [...], "cost_volume": tensor (optional),
    "first_grad": {leaf: tensor}, "change": {leaf: tensor}}."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    gnorm = {n: float(g.norm()) for n, g in ref["first_grad"].items()}
    med = _median(gnorm.values())
    keep = [n for n, v in gnorm.items() if v >= NEGLIGIBLE_GRAD * med]
    out = {"loss_gap": max(losses)}
    if "cost_volume" in prog:
        out["cv_gap"] = abs_rel(prog["cost_volume"], ref["cost_volume"])
    for key, name in (("first_grad", "grad_gap"), ("change", "change_gap")):
        gaps, diffs = _leaf_gaps(prog[key], ref[key], keep)
        worst = max(gaps, key=gaps.get)
        out[name] = gaps[worst]
        out[name + "_leaf"] = worst
        if key == "first_grad":
            out["grad_gap_median"] = _median(gaps.values())
            out["grad_diff_median"] = _median(diffs.values())
    return out


def checks(numbers: Dict, limits: Dict[str, float]) -> List[Check]:
    """Each limited number beside its limit; one that the run could not
    read (a window step that never came) is infinite, and fails."""
    return [Check(k, float(numbers.get(k, math.inf)), float(limits[k]))
            for k in limits]
