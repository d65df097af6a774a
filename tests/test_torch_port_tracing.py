"""The port's spans (`graspnet_tpu_torch/utils/tracing.py`) on the CPU.

* The span API: nesting, parents and trace ids; no span lost from 16
  contending threads; with no recorder and no profiler nothing is kept
  and no `record_function` entered; under `device_trace`, or any
  torch.profiler, each span of the traced thread is a `user_annotation`
  of the Chrome trace; a recording's clock mapping puts a span within
  0.5 ms of its twin; `into` sums a span's seconds in a caller's dict.
* The program's spans: `GraspService.compute` at `GraspNetConfig.tiny()`
  records every span of the robot path under the request's trace id, per
  request and through the micro-batcher, and its reply carries their
  times; two concurrent requests each get their own reply timings; a tiny `apps/train.py::train` run records the
  loop's spans a step and `data.get_data_label` on the loader's threads.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from graspnet_tpu_torch.apps import pipeline, train as cli
from graspnet_tpu_torch.apps.service import GraspService, ServiceConfig
from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.utils import tracing
from graspnet_tpu_torch.utils.tracing import TRACE_FILE, device_trace, record_interval, recording, span

from tests.mini_dataset import make_mini_dataset

WAIT_S = 120
ROBOT_SPANS = {"service.compute", "service.sample", "pipeline.dispatch", "pipeline.fetch", "collision.downsample",
               "collision.detect", "service.select", "service.reply"}
REPLY_SPANS = ROBOT_SPANS - {"service.compute", "service.reply"}  # in the reply's timings_ms
TRAIN_SPANS = {"train.step", "train.enqueue", "train.loader_wait", "train.prepare", "train.read_metrics"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_cloud(rng, n=3000):
    cloud = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    cloud[:, 2] += 0.5
    return cloud


# ------------------------------------------------------------- the API ----


def test_nesting_parents_and_trace_ids():
    with recording() as rec:
        with span("root", trace=7) as root:
            with span("child") as child:
                with span("leaf", rows=2) as leaf:
                    leaf.count(rows=3, batch=1)
            with span("other", trace="own"):
                pass
        with span("orphan"):
            pass
    got = {s.name: s for s in rec.drain()}
    assert [s.name for s in (got["leaf"], got["child"], got["other"], got["root"])] == \
        ["leaf", "child", "other", "root"]
    assert got["root"].parent is None and got["child"].parent == root.id and got["leaf"].parent == child.id
    assert got["leaf"].trace == got["child"].trace == 7 and got["other"].trace == "own"
    assert got["orphan"].trace is None and got["orphan"].parent is None
    assert got["leaf"].counts == {"rows": 5, "batch": 1}
    assert root.start_ns <= child.start_ns <= leaf.start_ns <= leaf.end_ns <= child.end_ns <= root.end_ns
    assert leaf.seconds >= 0 and all(s.thread == threading.get_ident() for s in got.values())
    assert rec.drain() == []


def test_record_interval_takes_the_enclosing_span():
    with recording() as rec:
        with span("root", trace=3) as root:
            s = record_interval("waited", 10, 30, batch=4)
    assert s.seconds == pytest.approx(20e-9)
    waited = [x for x in rec.drain() if x.name == "waited"]
    assert len(waited) == 1 and waited[0].parent == root.id and waited[0].trace == 3
    assert waited[0].counts == {"batch": 4}


def test_no_span_lost_from_contending_threads():
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                with span("outer", trace=(k, i)):
                    with span("inner"):
                        pass
        with recording() as rec:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.drain()
    assert len(spans) == 2 * n_threads * n
    outer = {s.id: s for s in spans if s.name == "outer"}
    assert len({s.trace for s in outer.values()}) == n_threads * n
    for s in spans:
        if s.name == "inner":
            assert outer[s.parent].trace == s.trace and outer[s.parent].thread == s.thread


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no recorder on")

    monkeypatch.setattr(tracing, "record_function", refuse)
    with span("off", trace=1) as s:
        s.count(rows=1)
    assert s.seconds >= 0 and s.end_ns >= s.start_ns and not s._on
    assert tracing.current_trace() is None
    with recording() as rec:  # on, with no profiler: still no record_function
        with span("on"):
            pass
    assert [x.name for x in rec.drain()] == ["on"]
    with span("after"):
        pass
    assert rec.drain() == []


def test_spans_are_user_annotations_in_the_device_trace(tmp_path):
    with device_trace(str(tmp_path)):
        with span("outer.region"):
            with span("inner.region"):
                torch.ones(8).sum()
        with span("after.region", trace=2):
            pass
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer.region", "inner.region", "after.region"} <= set(ann)
    assert ann["outer.region"]["tid"] == ann["inner.region"]["tid"] == ann["after.region"]["tid"]
    outer, inner = ann["outer.region"], ann["inner.region"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::sum"]
    assert any(inner["ts"] <= e["ts"] <= inner["ts"] + inner["dur"] for e in ops)


def test_spans_are_user_annotations_under_any_profiler(tmp_path):
    """With no recording and no `device_trace`, a caller's own profiler
    still gets the spans of its thread, nested as they ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("bare.outer", trace=4):
            assert tracing.current_trace() == 4
            with span("bare.inner"):
                torch.ones(8).sum()
    assert tracing.current_trace() is None
    path = tmp_path / "bare.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"bare.outer", "bare.inner"} <= set(ann)
    outer, inner = ann["bare.outer"], ann["bare.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    with span("bare.after") as s:
        pass
    assert not s._on


def test_into_sums_the_seconds_by_name():
    got = {"kept": 1.0}
    for _ in range(2):
        with span("summed", into=got) as s:
            time.sleep(0.001)
    assert set(got) == {"kept", "summed"} and got["kept"] == 1.0
    assert got["summed"] >= 0.002 and got["summed"] >= s.seconds
    with pytest.raises(ValueError):
        with span("raised", into=got):
            raise ValueError
    assert "raised" in got


def test_clock_mapping_puts_a_span_on_its_twin(tmp_path):
    """The twin opens before the span's first stamp and closes after its
    last, by the cost of `record_function` (and whatever the scheduler
    adds to it): mapped, each span lies inside its twin, and the closest
    start is within 0.5 ms of its twin's `ts`, as an error of the mapping
    would move every span alike."""
    with recording() as rec, device_trace(str(tmp_path)):
        for i in range(5):
            with span(f"mapped.{i}"):
                torch.ones(16).sum()
            time.sleep(0.002)
    trace = json.loads((tmp_path / TRACE_FILE).read_text())
    base = trace["baseTimeNanoseconds"]
    twins = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    gaps = []
    for s in rec.drain():
        twin = twins[s.name]
        start, end = rec.trace_ts_us(s.start_ns, base), rec.trace_ts_us(s.end_ns, base)
        assert twin["ts"] - 500 < start <= end < twin["ts"] + twin["dur"] + 500, s.name
        gaps.append(abs(start - twin["ts"]))
    assert len(gaps) == 5 and min(gaps) < 500, gaps


# ------------------------------------------------------- the service ----


@pytest.fixture(scope="module")
def services():
    cfg = GraspNetConfig.tiny()

    def mk(max_batch):
        return GraspService(ServiceConfig(model_cfg=cfg, depth_min=0.0, depth_max=10.0, collision_thresh=0.01,
                                          max_batch=max_batch, batch_wait_ms=1.0, device="cpu"))

    made = {1: mk(1), 4: mk(4)}
    yield made
    for s in made.values():
        s.close()


@pytest.mark.parametrize("max_batch", [1, 4], ids=["per_request", "batcher"])
def test_compute_records_every_robot_span_under_one_trace_id(services, max_batch):
    svc = services[max_batch]
    cloud = scene_cloud(np.random.default_rng(11))
    with recording() as rec:
        reply = svc.compute(cloud)
    assert reply["ok"]
    spans = rec.drain()
    root = [s for s in spans if s.name == "service.compute"]
    assert len(root) == 1
    mine = [s for s in spans if s.trace == root[0].trace]
    want = ROBOT_SPANS | ({"batcher.queue", "batcher.dispatch", "batcher.finish"} if max_batch > 1 else set())
    assert {s.name for s in mine} == want and len(mine) == len(spans)
    select = next(s for s in mine if s.name == "service.select")
    assert select.counts["rows"] > 0 and select.parent == root[0].id
    if max_batch > 1:
        queue = next(s for s in mine if s.name == "batcher.queue")
        assert queue.counts == {"batch": 1} and queue.thread == root[0].thread
        assert reply["batch"] == 1 and reply["timings_ms"]["queue"] >= 0
        fetch = next(s for s in mine if s.name == "pipeline.fetch")
        assert fetch.thread != root[0].thread  # the batcher's finish thread
        assert set(reply["timings_ms"]) == {"infer", "collision", "queue"} | REPLY_SPANS
    else:
        assert set(reply["timings_ms"]) == {"infer", "collision"} | REPLY_SPANS
    assert reply["timings_ms"]["infer"] > 0 and reply["timings_ms"]["collision"] > 0
    for s in mine:  # the reply's span times are the recorded spans'
        if s.name in REPLY_SPANS:
            assert reply["timings_ms"][s.name] == pytest.approx(s.seconds * 1e3), s.name
    t = reply["timings_ms"]
    assert t["pipeline.dispatch"] <= t["infer"]  # the fetch's span also builds the groups after it
    if max_batch == 1:
        assert t["collision.downsample"] + t["collision.detect"] <= t["collision"] * (1 + 1e-9)


def test_concurrent_computes_carry_their_own_timings(services, monkeypatch):
    """Request A has a short decode and waits in its selection until B,
    whose decode and filter take a second more each, has replied: each
    reply still carries its own infer and collision times."""
    svc = services[1]
    pipe = svc.pipe
    b_done = threading.Event()

    def sleep_in_b():
        if threading.current_thread().name == "B":
            time.sleep(1.0)

    class SlowDetector(pipeline.ModelFreeCollisionDetector):
        def detect(self, *args, **kw):
            sleep_in_b()
            return super().detect(*args, **kw)

    def slow_dispatch(*args, dispatch=pipe.dispatch_grasps_batch):
        handle = dispatch(*args)
        sleep_in_b()  # inside the infer interval: after the dispatch, before the fetch
        return handle

    def mask_filter(gg, mask_points, thresh):
        if threading.current_thread().name == "A":
            assert b_done.wait(WAIT_S)
        return gg

    monkeypatch.setattr(pipe, "dispatch_grasps_batch", slow_dispatch)
    monkeypatch.setattr(pipeline, "ModelFreeCollisionDetector", SlowDetector)
    monkeypatch.setattr(svc, "filter_by_mask_proximity", mask_filter)
    rng = np.random.default_rng(3)
    clouds = {"A": scene_cloud(rng), "B": scene_cloud(rng)}
    replies = {}

    def request(name):
        replies[name] = svc.compute(clouds[name], mask_points=clouds[name][:10] if name == "A" else None)
        if name == "B":
            b_done.set()

    threads = [threading.Thread(target=request, args=(n,), name=n) for n in ("A", "B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    a, b = replies["A"]["timings_ms"], replies["B"]["timings_ms"]
    assert b["infer"] >= 1000 and b["collision"] >= 1000
    assert a["infer"] < 1000 and a["collision"] < 1000


# ---------------------------------------------------------- training ----


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 4 frames a split: two steps an epoch at batch 2
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_graspnet")), num_view=60, n_frames=4)


def test_train_records_the_loop_spans_and_the_label_prep(root, tmp_path):
    argv = ["--dataset_root", root, "--camera", "realsense", "--log_dir", str(tmp_path), "--tiny",
            "--device", "cpu", "--num_workers", "2", "--log_every", "1", "--num_objects", "3", "--max_epoch", "1"]
    with recording() as rec:
        assert cli.main(argv) == 0
    spans = rec.drain()
    main = threading.get_ident()
    steps = {s.trace: s for s in spans if s.name == "train.step"}
    assert sorted(steps) == [1, 2] and all(s.thread == main for s in steps.values())
    for trace, step in steps.items():
        inside = {s.name for s in spans if s.trace == trace and s.parent == step.id}
        # the epoch's last step finds the loader empty: nothing to prepare
        assert inside == (TRAIN_SPANS - {"train.step"}) - ({"train.prepare"} if trace == 2 else set())
    labels = [s for s in spans if s.name == "data.get_data_label"]
    assert labels and all(s.thread != main and s.parent is None for s in labels)
    assert {s.trace for s in labels} <= set(range(4))
