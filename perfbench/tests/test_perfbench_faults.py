"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run but the look for a card (``harness.run`` on
the CPU at a tiny shape, float32 so that a sound run reads far below every
limit), with one fault planted in the program under test, and sees
``correct`` false: for the frame cells a refinement step that returns its
state unchanged, half of the batch left out, and a map altered where it is
produced; for the training cell a step that leaves the state unchanged,
half of the batch left out with the mean taken over the rest, and the
cost volume altered where it is produced, each from the first step on and
each from the window's first step on (the set-up's steps sound), which
only the check of the step drawn from the window can see. (One card: there
is no exchange between chips to leave out.) The limits are the committed
ones.
"""

import time

import pytest
import torch

from perfbench import harness
from magnet_tpu_torch.models import magnet as mg
from magnet_tpu_torch.nn import gnet
from magnet_tpu_torch.train import losses, optim

SEED = 2147483701


def run(cell, tiny):
    return harness.run(cell, SEED, 0.2, False, time.perf_counter(),
                       device="cpu", override=tiny("float32"))


def test_a_sound_run_is_correct(tiny):
    for cell in ("scannet.video_b4", "scannet.train_fnet"):
        assert run(cell, tiny)["correct"], cell


def unchanged_update(self, cost_volume, feat_contrib, ref_gaussian):
    return ref_gaussian


def half_batch_forward(forward):
    def fwd(self, ref_img, src_imgs, *geo, **kw):
        h = ref_img.shape[0] // 2
        preds = forward(self, ref_img[:h], src_imgs[:h],
                        *[g[:h] for g in geo], **kw)
        return [torch.cat([p, p], 0) for p in preds]
    return fwd


def altered_maps(upsample):
    def up(depth, mask, k):
        out = upsample(depth, mask, k)
        out[-1] = out[-1] * 1.1
        return out
    return up


@pytest.mark.parametrize("fault", ["unchanged step", "half batch",
                                   "altered map"])
def test_frame_faults_fail(fault, monkeypatch, tiny):
    if fault == "unchanged step":
        monkeypatch.setattr(gnet.GNet, "forward", unchanged_update)
    elif fault == "half batch":
        monkeypatch.setattr(mg.Magnet, "forward",
                            half_batch_forward(mg.Magnet.forward))
    else:
        monkeypatch.setattr(mg, "upsample_via_mask",
                            altered_maps(mg.upsample_via_mask))
    r = run("scannet.video_b4", tiny)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def half_batch_loss(loss):
    def l1(pred, gt, mask):
        h = pred.shape[0] // 2
        return loss(pred[:h], gt[:h], mask[:h])
    return l1


def altered_sweep(sweep):
    def cv(*args):
        out = sweep(*args)
        return out * torch.linspace(0.9, 1.1, out.shape[-1])
    return cv


@pytest.mark.parametrize("window_only", [False, True],
                         ids=["from the start", "in the window"])
@pytest.mark.parametrize("fault", ["unchanged state", "half batch",
                                   "altered cost volume"])
def test_training_faults_fail(fault, window_only, monkeypatch, tiny):
    first = harness.load_json(
        harness.HERE / "traffic" / "train_stage2.json")["checked_steps"]
    done = {"steps": 0}

    def on():
        # from the start, or once the set-up's steps are done
        return not window_only or done["steps"] >= first

    def planted(name, obj, broken):
        sound = getattr(obj, name)
        monkeypatch.setattr(obj, name, lambda *a: (
            broken if on() else sound)(*a))

    sound_step = optim.ScheduledAdamW.step

    def step(self):
        if not (fault == "unchanged state" and on()):
            sound_step(self)
        done["steps"] += 1
    monkeypatch.setattr(optim.ScheduledAdamW, "step", step)
    if fault == "half batch":
        planted("fnet_l1_loss", losses,
                half_batch_loss(losses.fnet_l1_loss))
    elif fault == "altered cost volume":
        planted("cost_volume_sweep", mg,
                altered_sweep(mg.cost_volume_sweep))
    r = run("scannet.train_fnet", tiny)
    assert not r["correct"], r["checks"]
