"""The AdaBins cell, ``adabins_kitti.images_b16``: its model FLOPs against
hand arithmetic at the published 352x1216, a run through ``harness.run``
on the CPU at the configuration's tiny size, the seeded weights that give
the depth map metres of spread and keep the bins' softmax off one-hot,
and two faults of the bins head planted in the program that the check
catches: a map flattened to its mean, and the bins' right edges weighed in
place of their centres (half a bin too deep everywhere)."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from magnet_tpu_torch.models.adabins import AdaBins
from magnet_tpu_torch.nn.layers import conv2d, nchw, nhwc
from perfbench import harness, weights
from perfbench.drivers import images
from perfbench.reference import adabins as ref_adabins

CELL = "adabins_kitti.images_b16"
SEED = 2147483713
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SPAN_METRICS = ("trunk_ms.maps", "decoder_ms.maps", "vit_ms.maps",
                "bins_ms.maps")
# the seeded softmax's mean entropy over the bins, in nats, at the tiny
# size: 5.19 at this seed (2.13 without the conv_out pin; ln 256 = 5.55 is
# uniform), and the depth map's spread over the image, 1.55 m (0.09 m
# without the standardised conv)
ENTROPY_FLOOR = 4.0
SPREAD_FLOOR_M = 1.0


def _cell():
    _, cfg, mix, limits = harness.find(BENCH, CELL)
    return cfg, mix, limits


def _flops(fn) -> float:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return float(mode.get_total_flops())


def hand_counts():
    """Each part's FLOPs at 352x1216, one image, from the widths (two a
    multiply-add; FlopCounterMode's rule), the B5 trunk's aside."""
    h, w = 176, 608                     # u, half resolution
    S, E, F = 11 * 38, 128, 1024
    ups = {"up1": (2224, 1024, 22 * 76), "up2": (1088, 512, 44 * 152),
           "up3": (552, 256, 88 * 304), "up4": (280, 128, h * w)}
    out = {"conv2": 2 * 2048 * 2048 * 13 * 40}
    out.update({k: 2 * 9 * (cin * c + c * c) * px
                for k, (cin, c, px) in ups.items()})
    out.update({"conv3": 2 * 9 * 128 * 128 * h * w,
                "conv3x3": 2 * 9 * 128 * 128 * h * w,
                "embedding": 2 * 128 * E * 16 * 16 * S,
                "layers": 4 * (2 * S * E * 3 * E + 2 * 2 * S * S * E
                               + 2 * S * E * E + 2 * 2 * S * E * F),
                "regressor": 2 * (E * 256 + 256 * 256 + 256 * 256),
                "dot_product": 2 * 128 * 128 * h * w,
                "conv_out": 2 * 128 * 256 * h * w})
    return {k: float(v) for k, v in out.items()}


@torch.no_grad()
def test_model_flops_by_part():
    cfg, mix, _ = _cell()
    driver = harness.driver_for(cfg, mix, 1, "cpu")
    total = driver.model_flops_per_unit()
    with torch.device("meta"):
        ref = driver.layout().eval()
        x = torch.empty(1, 3, cfg["shape"]["H"], cfg["shape"]["W"])
        feats = ref.encoder.original_model(x)
        d, vit = ref.decoder, ref.adaptive_bins_layer
        pt = vit.patch_transformer
        y = [d.conv2(feats[4])]
        for up, skip in zip((d.up1, d.up2, d.up3, d.up4), feats[3::-1]):
            y.append(up(y[-1], skip))
        u = d.conv3(y[-1])
        tokens = pt(u)
        got = {"trunk": _flops(lambda: ref.encoder.original_model(x)),
               "conv2": _flops(lambda: d.conv2(feats[4])),
               **{f"up{i}": _flops(lambda i=i: getattr(d, f"up{i}")(
                   y[i - 1], feats[4 - i])) for i in range(1, 5)},
               "conv3": _flops(lambda: d.conv3(y[-1])),
               "conv3x3": _flops(lambda: vit.conv3x3(u)),
               "embedding": _flops(lambda: pt.embedding_convPxP(u)),
               "layers": _flops(lambda: [layer(tokens) for layer in
                                         pt.transformer_encoder.layers]),
               "regressor": _flops(lambda: vit.regressor(tokens[0])),
               "dot_product": _flops(lambda: vit.dot_product(
                   u, tokens[1:129].permute(1, 0, 2))),
               "conv_out": _flops(lambda: ref.conv_out(u))}
    hand = hand_counts()
    assert {k: v for k, v in got.items() if k != "trunk"} == hand
    # the B5 trunk at 352x1216: 40.09 GFLOP (29 at 480x640, PERF.md)
    assert got["trunk"] == pytest.approx(40.09e9, rel=1e-3)
    assert sum(got.values()) == total
    # about 522 GFLOP a map
    assert total == pytest.approx(522e9, rel=0.02)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_cpu(trace, tiny):
    r = harness.run(CELL, SEED, 0.2, bool(trace), time.perf_counter(),
                    device="cpu", override=tiny("float32"))
    assert r["correct"], r["checks"]
    got = set(r["metrics"])
    if not trace:
        assert got == {"maps_per_s", "setup_s"}
        return
    # on the CPU no kernel operator runs: the roofline share is left out
    assert got == {"host_issue_ms.maps", "mfu_pct.maps", "idle_pct.maps",
                   *SPAN_METRICS}
    assert all(r["metrics"][m]["value"] > 0 for m in SPAN_METRICS)


def _entropy(p) -> float:
    return float(-(p * p.clamp_min(1e-30).log()).sum(1).mean())


@torch.no_grad()
def test_the_seeded_weights_give_the_map_spread_and_the_softmax_room(tiny):
    cfg, mix, limits = _cell()
    tiny("float32")(cfg, mix, limits)
    driver = harness.driver_for(cfg, mix, SEED, "cpu")
    ref = driver.reference()
    x = driver.image_sets(1)[0][:1].permute(0, 3, 1, 2)
    u = ref.features(x)
    # the standardised feature: mean 0 and deviation 1 per channel
    assert float(u.mean((2, 3)).abs().max()) < 1e-3
    assert float((u.std((2, 3)) - 1).abs().max()) < 1e-3
    p = ref.conv_out(ref.adaptive_bins_layer(u)[1])
    assert ENTROPY_FLOOR < _entropy(p) < math.log(cfg["shape"]["n_bins"])
    assert float(ref.from_features(u)[1].std()) > SPREAD_FLOOR_M
    # without the conv_out pin the softmax is far sharper
    sd = weights.make_weights(driver.layout(), SEED, "cpu", "eval")
    sd.update({k: v for k, v in driver.weights().items()
               if k.startswith(cfg["standardise"] + ".")})
    ref.load_state_dict(sd)
    assert _entropy(ref.conv_out(ref.adaptive_bins_layer(u)[1])) < 3.0
    # without the standardised conv the map is nearly flat
    ref.load_state_dict(weights.make_weights(driver.layout(), SEED, "cpu",
                                             "eval", cfg["pins"]))
    assert float(ref.from_features(ref.features(x))[1].std()) < 0.5


def flat_map(self, u, queries, edges):
    """The bins head with its map flattened to the mean of each image."""
    d = _bins_head(self, u, queries, edges)
    return d.mean((1, 2), keepdim=True).expand_as(d).contiguous()


def right_edges(self, u, queries, edges):
    """The bins head with each bin's right edge weighed in place of its
    centre: half a bin too deep everywhere."""
    v = nhwc(conv2d(nchw(u), self.adaptive_bins_layer.conv3x3))
    B, h, w, C = v.shape
    r = torch.bmm(v.view(B, h * w, C), queries.transpose(1, 2))
    logits = nhwc(conv2d(nchw(r.view(B, h, w, -1)), self.conv_out[0]))
    p = torch.softmax(logits, dim=-1, dtype=torch.float32)
    return torch.bmm(p.view(B, h * w, -1), edges[:, 1:, None]).view(B, h, w)


_bins_head = AdaBins.bins_head


@pytest.mark.parametrize("fault, caught_by",
                         [(flat_map, "depth_rel"),
                          (right_edges, "head_bins")],
                         ids=["flat_map", "right_edges"])
def test_a_fault_of_the_bins_head_fails(fault, caught_by, monkeypatch,
                                        tiny):
    monkeypatch.setattr(AdaBins, "bins_head", fault)
    r = harness.run(CELL, SEED, 0.2, False, time.perf_counter(),
                    device="cpu", override=tiny("float32"))
    assert not r["correct"]
    failed = {k for k, c in r["checks"].items()
              if not c["value"] <= c["limit"]}
    assert caught_by in failed, r["checks"]
    # the stages before the head are sound
    assert {"dec_rel", "edges_rel"}.isdisjoint(failed)


def test_the_bins_gap_is_the_median_pixels_in_bins():
    edges = torch.linspace(0.0, 80.0, 257)
    r = torch.full((4, 4), 30.0)
    off = torch.full((4, 4), 80 / 512)       # half a bin
    off[0] = -off[0]
    off[1, :3] = 40.0                        # a few pixels far off
    assert images.bins_gap(r + off, r, edges) == pytest.approx(0.5)
    assert images.bins_gap(r[:2], r, edges) == math.inf


def test_the_configuration_states_the_references_widths():
    cfg, _, _ = _cell()
    s = cfg["shape"]
    with torch.device("meta"):
        ref = ref_adabins.AdaBins(s["n_bins"], s["min_depth"],
                                  s["max_depth"])
    vit = ref.adaptive_bins_layer
    layer = vit.patch_transformer.transformer_encoder.layers[0]
    assert (len(vit.patch_transformer.transformer_encoder.layers),
            layer.self_attn.embed_dim, layer.self_attn.num_heads,
            layer.linear1.out_features, vit.n_query_channels,
            vit.patch_transformer.positional_encodings.shape[0],
            vit.patch_transformer.embedding_convPxP.kernel_size[0],
            vit.regressor[0].out_features, ref.conv_out[0].out_channels,
            ref.decoder.conv3.out_channels, layer.norm1.eps) == (
        s["num_layers"], s["embedding_dim"], s["num_heads"],
        s["dim_feedforward"], s["n_query_channels"], s["positions"],
        s["patch_size"], s["regressor_hidden"], s["n_bins"],
        s["decoder_out"], s["layer_norm_eps"])
    assert [getattr(ref.decoder, f"up{i}")._net[0].out_channels
            for i in range(1, 5)] == s["decoder_widths"]
    assert ref.decoder.conv2.out_channels == s["decoder_features"]
