"""The program's spans (magnet_tpu_torch/utils/profiling.py::stage): what a
``StageTimes`` records, that a span costs nothing recorded when off, the
ranges a profiler sees in ``Magnet.forward``, and (on a card) that no CUDA
event is recorded while the stream captures a graph."""

import threading
import time

import pytest
import torch

from magnet_tpu_torch.models.magnet import Magnet
from magnet_tpu_torch.utils import profiling
from magnet_tpu_torch.utils.profiling import StageTimes, stage

H, W, B, V = 64, 96, 1, 1
INFERENCE_SPANS = ("forward", "D-Net", "D-Net trunk", "D-Net decoder",
                   "F-Net", "fuse", "cost volume", "G-Net update",
                   "mask head + upsample")


def _spin(seconds):
    """Busy on this thread's CPU clock for ``seconds``."""
    t = time.thread_time()
    while time.thread_time() - t < seconds:
        pass


def test_nested_spans_record_parent_wall_and_cpu_time():
    with StageTimes() as st:
        with stage("outer"):
            with stage("inner"):
                _spin(0.005)
            with stage("inner"):
                pass
    assert StageTimes.active is None
    assert [h.parent for h in st.host["inner"]] == ["outer", "outer"]
    (outer,) = st.host["outer"]
    assert outer.parent is None
    inner = st.host["inner"][0]
    assert inner.cpu_s >= 0.005 and inner.wall_s >= inner.cpu_s * 0.5
    assert outer.wall_s >= inner.wall_s and outer.cpu_s >= inner.cpu_s
    assert st.stack() == []


def test_cpu_time_counts_every_thread_and_parents_are_per_thread():
    """A span that waits on another thread takes that thread's CPU time (as
    the caller's span takes autograd's device thread's in ``backward``); a
    span on the other thread has no parent from the caller's."""
    def work():
        with stage("worker"):
            _spin(0.02)
    with StageTimes() as st:
        with stage("wait"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    assert st.host["wait"][0].cpu_s >= 0.02
    assert st.host["worker"][0].parent is None


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def boom(name):
        raise AssertionError(f"range {name!r} opened")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert StageTimes.active is None
    assert stage("a") is stage("b")      # one shared no-op, nothing made
    with stage("a"):
        pass
    st = StageTimes()
    with stage("a"):
        pass
    assert not st.events and not st.host


def test_events_keep_their_shape():
    """``events``: name -> a list of (start, end) CUDA event pairs, as
    ``profile_fnet_train.step_account`` and the benchmark read it; none on a
    host without a card, where ``ms()`` has nothing to give."""
    with StageTimes() as st:
        with stage("a"):
            pass
    assert isinstance(st.events, dict)
    if not st.cuda:
        assert dict(st.events) == {} and st.ms() == {}
        assert len(st.host["a"]) == 1
        return
    (pair,) = st.events["a"]
    assert all(isinstance(e, torch.cuda.Event) for e in pair)
    assert set(st.ms()) == {"a"}


def _model():
    """A Magnet of two iterations in eval mode, with constant weights in
    place of the builder's random ones (which take seconds to draw)."""
    with torch.device("meta"):
        model = Magnet(n_iters=2)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            if t.is_floating_point():
                t.fill_(0.01)
    return model.eval()


def _inputs():
    g = torch.Generator().manual_seed(0)
    h, w = H // 4, W // 4
    intM = torch.tensor([[[W * 0.8, 0.0, W / 2], [0.0, W * 0.8, H / 2],
                          [0.0, 0.0, 1.0]]])
    v, u = torch.meshgrid(torch.arange(h) * 4.0 + 1.5,
                          torch.arange(w) * 4.0 + 1.5, indexing="ij")
    pix = torch.stack([u.flatten(), v.flatten(), torch.ones(h * w)])
    rays2d = (torch.linalg.inv(intM[0]) @ pix)[None]
    return [torch.rand(B, H, W, 3, generator=g),
            torch.rand(B, V, H, W, 3, generator=g),
            torch.eye(3).expand(B, V, 3, 3).contiguous(),
            torch.tensor([[[0.1, 0.0, 0.0]]]).expand(B, V, 3).contiguous(),
            torch.ones(B, V), intM, rays2d]


def test_forward_ranges_nest_under_the_profiler():
    """Each inference span of ``Magnet.forward`` is a prefixed range, once
    a forward or once an iteration, and ``forward`` holds ``D-Net`` holds
    ``D-Net trunk`` on the clock of the trace."""
    model = _model()
    args = _inputs()
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.no_grad(), torch.profiler.profile(activities=[cpu]) as prof:
        model(*args)
    pre = profiling.RANGE_PREFIX
    ranges = {}
    for e in prof.events():
        if e.name.startswith(pre):
            ranges.setdefault(e.name[len(pre):], []).append(e.time_range)
    per_iter = {"cost volume", "G-Net update"}
    assert {k: len(v) for k, v in ranges.items()} == {
        k: 2 if k in per_iter else 1 for k in INFERENCE_SPANS}

    def inside(inner, outer):
        (i,), (o,) = ranges[inner], ranges[outer]
        return o.start <= i.start and i.end <= o.end
    assert inside("D-Net", "forward") and inside("D-Net trunk", "D-Net")
    assert inside("D-Net decoder", "D-Net") and inside("fuse", "forward")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_no_event_while_the_stream_captures(cuda):
    x = torch.zeros(256, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)                       # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with StageTimes() as st:
        with stage("eager"):
            x.add_(1)
        with torch.cuda.graph(graph):
            with stage("captured"):
                x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert len(st.events["eager"]) == 1 and "captured" not in st.events
    assert len(st.host["captured"]) == 1
    assert float(x[0]) == 3.0             # warm-up, eager, one replay
