"""Seeded weights: MaGNet's layouts get the tensors they always got, bit for
bit, and each rule for other layers fills its keys as ``weights`` states."""

import hashlib

import pytest
import torch
import torch.nn as nn

from perfbench import weights
from perfbench.reference import nets

SEED = 2147483777
# sha256 of the state dicts below as the rules for convolutions and batch
# norms alone made them, before rules for other layers were added
PINNED = {
    "Magnet eval":
        "fa7fc1d55e5612f6dc41fdafc4ce42b6db26a531d754d593f3e02456c76d6079",
    "MagnetF train":
        "afa5dac65df1dce2886a166d9e82fc7c6e6759b0c6c873da4a76fb234665929b"}


def digest(sd) -> str:
    h = hashlib.sha256()
    for key in sorted(sd):
        t = sd[key].detach().cpu().contiguous()
        h.update(key.encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_magnet_layouts_keep_their_weights():
    with torch.device("meta"):
        magnet, magnet_f = nets.Magnet(5, 64, 4), nets.MagnetF(64)
    got = {"Magnet eval": weights.make_weights(magnet, SEED, "cpu", "eval"),
           "MagnetF train": weights.make_weights(magnet_f, SEED, "cpu",
                                                 "train")}
    assert {k: digest(v) for k, v in got.items()} == PINNED


class Layers(nn.Module):
    E = 256

    def __init__(self):
        super().__init__()
        E = self.E
        self.linear = nn.Linear(E, 2 * E)
        self.ln = nn.LayerNorm(E)
        self.gn = nn.GroupNorm(8, E)
        self.attn = nn.MultiheadAttention(E, 4)
        self.pos = nn.Parameter(torch.empty(500, E))


def std_of(t):
    return float(t.float().std())


@pytest.mark.parametrize("scheme", weights.SCHEMES)
def test_each_rule_fills_its_keys(scheme):
    with torch.device("meta"):
        layout = Layers()
    sd = weights.make_weights(layout, SEED, "cpu", scheme)
    E = Layers.E
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in layout.state_dict().items()}
    eval_ = scheme == "eval"
    # Linear, and attention's packed and output projections: as a 1x1 conv
    for key, fan_in, out in (("linear.weight", E, 2 * E),
                             ("attn.in_proj_weight", E, 3 * E),
                             ("attn.out_proj.weight", E, E)):
        want = fan_in ** -0.5 if eval_ else (2.0 / out) ** 0.5
        assert std_of(sd[key]) == pytest.approx(want, rel=0.05), key
    for key in ("linear.bias", "attn.in_proj_bias", "attn.out_proj.bias"):
        if eval_:
            assert std_of(sd[key]) == pytest.approx(0.02, rel=0.15), key
        else:
            assert not sd[key].any(), key
    for norm in ("ln", "gn"):
        scale, shift = sd[norm + ".weight"], sd[norm + ".bias"]
        if eval_:
            assert 0.5 <= float(scale.min()) and float(scale.max()) <= 1.5
            assert float(scale.std()) > 0.2
            assert std_of(shift) == pytest.approx(0.1, rel=0.15), norm
        else:
            assert torch.equal(scale, torch.ones(E))
            assert not shift.any()
    # a bare parameter, by the last rule
    assert std_of(sd["pos"]) == pytest.approx(0.02, rel=0.05)
    assert abs(float(sd["pos"].mean())) < 0.002
    # no two entries share a slice of the draws
    flat = [v.flatten() for k, v in sd.items() if sd[k].std() > 0]
    assert len({float(v[0]) for v in flat}) == len(flat)


def test_a_buffer_no_rule_makes_is_refused():
    layout = nn.Linear(2, 2)
    layout.register_buffer("table", torch.zeros(3))
    with pytest.raises(KeyError):
        weights.make_weights(layout, SEED, "cpu", "eval")


@pytest.mark.parametrize("layer", [
    lambda: nn.Conv1d(192, 64, 3),
    lambda: nn.ConvTranspose2d(8, 8, 2),
    lambda: nn.Embedding(10, 16),
    lambda: nn.MultiheadAttention(16, 4, kdim=8, vdim=8),
], ids=["Conv1d", "ConvTranspose2d", "Embedding", "attention_qkv_split"])
def test_a_torch_layer_no_rule_covers_is_refused(layer):
    """The last rule seeds only parameters of the model's own modules; a
    torch.nn layer with no rule of its own scale raises."""
    layout = nn.Sequential(nn.Linear(4, 4), layer())
    with pytest.raises(KeyError):
        weights.make_weights(layout, SEED, "cpu", "eval")


def test_a_subclassed_torch_layer_takes_its_rule_once():
    """A model's own subclass of a covered layer takes the layer's rule,
    not the last rule as well."""
    class Proj(nn.Linear):
        pass

    layout = Proj(64, 32)
    sd = weights.make_weights(layout, SEED, "cpu", "eval")
    assert set(sd) == {"weight", "bias"}
    assert std_of(sd["weight"]) == pytest.approx(64 ** -0.5, rel=0.1)

