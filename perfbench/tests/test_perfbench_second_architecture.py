"""A second architecture enters the benchmark as new files and entries
only. A toy one is defined here as a later change would define it in files
of its own: a configuration with its ``tiny`` size and no camera or cost
volume, a driver that brings its model FLOPs a unit, a plain reference,
its limits, and its cell appended to the ``workloads`` of the metrics it
reports. It runs through ``harness.run`` on the CPU with the benchmark's
own seeded weights, metric readers, judge and test fixtures, none of them
edited: only ``harness.find`` and ``harness.driver_for`` are pointed at
what a new cell's files would give them."""

import copy
import time

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, harness, weights
from perfbench.reference.precision import Precision, plain_float32
from perfbench.spans import Spans

CELL = "toy.images"
SEED = 2147483713
CONFIG = {
    "name": "toy",
    "test_flags": ["--input_height", "480", "--input_width", "640"],
    "shape": {"H": 480, "W": 640, "C": 32, "E": 32, "heads": 4,
              "patch": 16, "positions": 1200},
    "tiny": {"H": 32, "W": 48}}
MIX = {"driver": "toy_images", "batch": 4, "distinct_batches": 6,
       "checked_forwards": 1, "profiled_units": 4}
# float32 against float32 in another order: gaps of a few 1e-7; the fp8
# control reads a few 1e-2
LIMITS = {"out_rel": 1e-4}
REPORTED = ("maps_per_s", "setup_s", "mfu_pct.maps", "idle_pct.maps",
            "kernels_roofline_pct.maps")


class Toy(nn.Module):
    """The program under test: a conv stem, a patch embedding with learned
    positions, one attention block and a linear head, one number a patch."""

    def __init__(self, C, E, heads, patch, positions):
        super().__init__()
        self.stem = nn.Conv2d(3, C, 3, padding=1)
        self.norm = nn.GroupNorm(4, C)
        self.embed = nn.Conv2d(C, E, patch, stride=patch)
        self.pos = nn.Parameter(torch.empty(positions, E))
        self.attn = nn.MultiheadAttention(E, heads, batch_first=True)
        self.ln = nn.LayerNorm(E)
        self.head = nn.Linear(E, 1)

    def forward(self, x):
        t = self.embed(F.relu(self.norm(self.stem(x))))
        t = t.flatten(2).transpose(1, 2)
        t = t + self.pos[:t.shape[1]]
        a, _ = self.attn(t, t, t, need_weights=False)
        return self.head(self.ln(t + a)).squeeze(-1)


def reference(sd, x, s, precision=Precision()):
    """The toy in plain operations from the state dict; every product's
    operands pass through ``precision``."""
    q = precision
    y = F.conv2d(q(x), q(sd["stem.weight"]), sd["stem.bias"], padding=1)
    y = F.relu(F.group_norm(y, 4, sd["norm.weight"], sd["norm.bias"]))
    t = F.conv2d(q(y), q(sd["embed.weight"]), sd["embed.bias"],
                 stride=s["patch"]).flatten(2).transpose(1, 2)
    t = t + sd["pos"][:t.shape[1]]
    B, N, E = t.shape
    h = s["heads"]
    qkv = q(t) @ q(sd["attn.in_proj_weight"]).T + sd["attn.in_proj_bias"]
    qh, kh, vh = (z.reshape(B, N, h, E // h).transpose(1, 2)
                  for z in qkv.chunk(3, -1))
    att = torch.softmax(q(qh) @ q(kh).transpose(-1, -2) * (E // h) ** -0.5,
                        -1)
    a = (q(att) @ q(vh)).transpose(1, 2).reshape(B, N, E)
    a = q(a) @ q(sd["attn.out_proj.weight"]).T + sd["attn.out_proj.bias"]
    t = F.layer_norm(t + a, (E,), sd["ln.weight"], sd["ln.bias"])
    return (q(t) @ q(sd["head.weight"]).T + sd["head.bias"]).squeeze(-1)


class ToyDriver:
    """A driver as ``perfbench/drivers/`` holds them: set-up, the traffic
    (closed loop, one batch at a time), the traced run's hooks, the model's
    FLOPs a unit counted on the reference, and the check."""
    unit = "maps"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.windows = []

    def layout(self):
        s = self.cfg["shape"]
        with torch.device("meta"):
            return Toy(s["C"], s["E"], s["heads"], s["patch"],
                       s["positions"])

    def weights(self):
        return weights.make_weights(self.layout(), self.seed, self.device,
                                    "eval")

    def images(self):
        g = torch.Generator(self.device).manual_seed(self.seed + 1)
        s = self.cfg["shape"]
        return [torch.randn(self.mix["batch"], 3, s["H"], s["W"],
                            generator=g, device=self.device)
                for _ in range(self.mix["distinct_batches"])]

    def setup(self):
        t = time.perf_counter()
        self.model = self.layout().to_empty(device=self.device)
        self.model.load_state_dict(self.weights())
        self.model.eval()
        self.data = self.images()
        self.setup_log = [("model and inputs", time.perf_counter() - t)]
        self.run_units(2, keep=False)
        self.setup_log.append(("warm-up", time.perf_counter() - t))

    def run_units(self, n_forwards=None, seconds=None, keep=True):
        i, t0 = 0, time.perf_counter()
        while not ((n_forwards is not None and i >= n_forwards) or
                   (seconds is not None
                    and time.perf_counter() - t0 >= seconds)):
            j = i % len(self.data)
            with torch.inference_mode():
                out = self.model(self.data[j])
            if keep:
                self.kept = (j, out.clone())
            i += 1
        elapsed = time.perf_counter() - t0
        self.windows.append((i, elapsed))
        return i, elapsed

    def units_of(self, forwards):
        return forwards * self.mix["batch"]

    def model_flops_per_unit(self):
        s = self.cfg["shape"]
        with torch.device("meta"):
            sd = {k: torch.empty(v.shape)
                  for k, v in self.layout().state_dict().items()}
            x = torch.empty(1, 3, s["H"], s["W"])
        mode = FlopCounterMode(display=False)
        with mode:
            reference(sd, x, s)
        return float(mode.get_total_flops())

    def open_spans(self):
        self.spans = Spans(self.device)
        return self.spans

    def close_spans(self):
        self.spans.close()

    def release(self):
        self.__dict__.pop("model", None)

    def numbers(self, subject="program"):
        plain_float32()
        j, out = self.kept
        sd = self.weights()
        ref = reference(sd, self.data[j], self.cfg["shape"])
        if subject != "program":
            out = reference(sd, self.data[j], self.cfg["shape"],
                            Precision(subject))
        return {"out_rel": float((out - ref).abs().max()
                                 / ref.abs().max())}

    def compared(self):
        return self.mix["batch"]


def toy_flops(s):
    """The toy's products by hand, one image (FlopCounterMode's rule: two
    operations a multiply-add, biases and elementwise work left out)."""
    H, W, C, E, P = s["H"], s["W"], s["C"], s["E"], s["patch"]
    N = (H // P) * (W // P)
    return (2 * H * W * C * 3 * 9 + 2 * N * E * C * P * P
            + 2 * N * E * 3 * E + 2 * 2 * N * N * E + 2 * N * E * E
            + 2 * N * E)


@pytest.fixture
def toy_cell(monkeypatch):
    """The toy cell as ``harness.run`` finds it once its files and entries
    exist: ``BENCHMARK.json`` with the toy appended, ``find`` giving the
    toy's configuration, mix and limits, ``driver_for`` its driver."""
    bench = copy.deepcopy(harness.load_json(harness.ROOT / "BENCHMARK.json"))
    bench["configs"].append({"name": "toy", "source": "this module",
                             "file": "perfbench/configs/toy.json",
                             "reduced": [], "why": "a second architecture"})
    bench["workloads"].append({"name": CELL, "config": "toy",
                               "traffic": "toy_images", "chips": 1,
                               "why": "the toy's images"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in REPORTED and "workloads" in m:
            m["workloads"].append(CELL)
    load_json, find, driver_for = (harness.load_json, harness.find,
                                   harness.driver_for)
    monkeypatch.setattr(harness, "load_json", lambda path: (
        copy.deepcopy(bench) if path == harness.ROOT / "BENCHMARK.json"
        else load_json(path)))
    monkeypatch.setattr(harness, "find", lambda b, name: (
        ({"name": CELL, "chips": 1}, copy.deepcopy(CONFIG), dict(MIX),
         dict(LIMITS)) if name == CELL else find(b, name)))
    monkeypatch.setattr(harness, "driver_for", lambda cfg, mix, seed, dev: (
        ToyDriver(cfg, mix, seed, dev) if mix["driver"] == "toy_images"
        else driver_for(cfg, mix, seed, dev)))
    return bench


def test_the_toy_counts_its_own_flops():
    s = dict(CONFIG["shape"], **CONFIG["tiny"])
    driver = ToyDriver(dict(CONFIG, shape=s), MIX, SEED, "cpu")
    assert driver.model_flops_per_unit() == toy_flops(s)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_second_architecture_runs_with_no_edit(trace, toy_cell, tiny,
                                                 monkeypatch):
    drivers = []
    monkeypatch.setattr(harness, "driver_for", lambda *a: (
        drivers.append(ToyDriver(*a)) or drivers[-1]))
    r = harness.run(CELL, SEED, 0.2, bool(trace), time.perf_counter(),
                    device="cpu", override=tiny("float32"))
    assert r["correct"], r["checks"]
    assert r["checks"]["out_rel"]["value"] < LIMITS["out_rel"]
    driver, = drivers
    # the seeded weights are weights.make_weights' for the toy's layout
    sd = weights.make_weights(driver.layout(), SEED, "cpu", "eval")
    assert set(sd) == set(Toy(32, 32, 4, 16, 1200).state_dict())
    got = r["metrics"]
    if not trace:
        assert set(got) == {"maps_per_s", "setup_s"}
        assert got["maps_per_s"]["value"] > 0
        return
    # on the CPU no kernel operator runs: the roofline share is left out
    assert set(got) == {"mfu_pct.maps", "idle_pct.maps"}
    n, window_s = driver.windows[1]
    s = dict(CONFIG["shape"], **CONFIG["tiny"])
    mfu = (100.0 * toy_flops(s) * driver.units_of(n)
           / (window_s * counts.PEAK_BF16_FLOPS))
    assert got["mfu_pct.maps"]["value"] == pytest.approx(mfu)
    assert r["device"]["window_s"] > 0


def test_its_fp8_control_fails(toy_cell, fp8_control):
    _, cfg, mix, limits = harness.find(toy_cell, CELL)
    checks = fp8_control(cfg, mix, limits)
    assert not all(c.ok for c in checks), checks


def test_shrink_touches_only_what_the_configuration_has(tiny):
    cfg, mix = copy.deepcopy(CONFIG), dict(MIX)
    tiny("float32")(cfg, mix, {})
    assert cfg["test_flags"] == ["--input_height", "32",
                                 "--input_width", "48"]
    assert cfg["shape"] == dict(CONFIG["shape"], H=32, W=48)
    assert {k: v for k, v in cfg.items()
            if k not in ("test_flags", "shape")} == {
        k: v for k, v in CONFIG.items() if k not in ("test_flags", "shape")}
    assert mix == dict(MIX, batch=2, distinct_batches=3, profiled_units=1)

