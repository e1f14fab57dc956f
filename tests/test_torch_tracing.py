"""The port's spans and counters (``gsplat_tpu_torch/tracing.py``) on the
CPU: a Trainer's iterations on ``make_scene_port``'s 48x48 scene (150
gaussians, 6 cameras) with tracing off and on, the spans each iteration
yields, the readbacks counted, and the spans under ``torch.profiler``."""
import json
import random

import pytest
import torch

from gsplat_tpu_torch import tracing
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.train.trainer import Trainer

from torch_helpers import (SCENE_CLASSES, dataset_args,  # noqa: F401
                           port_opt, scene_dir)

# the spans of every iteration, with their parents on the Trainer's thread
PARENTS = {"iter": None, "iter.batch": "iter", "iter.step": "iter",
           "step.forward": "iter.step",
           "rasterize.preprocess": "step.forward",
           "rasterize.binning": "step.forward",
           "rasterize.composite": "step.forward",
           "step.losses": "step.forward", "step.backward": "iter.step",
           "step.update": "iter.step", "iter.capacity": "iter"}


@pytest.fixture(scope="module")
def scene(scene_dir, tmp_path_factory):
    random.seed(0)
    model = GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                          device="cpu")
    return Scene(dataset_args(scene_dir, str(tmp_path_factory.mktemp("m"))),
                 model)


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.take()
    tracing.on()
    yield
    tracing.on(False)
    tracing.take()


def train(scene, iterations=4, log_every=2, profile_dir=None, **kw):
    """A fresh model from the scene's cloud and a Trainer over it, run for
    ``iterations`` (``profile_dir``: with a profiler window over iterations
    1 and 2); returns the Trainer."""
    pcd = scene.scene_info.point_cloud
    m = GaussianModel(3, num_class=SCENE_CLASSES, capacity=512, device="cpu")
    m.create_from_pcd(pcd.points, pcd.colors, scene.cameras_extent)
    m.training_setup()
    tr = Trainer(m, scene, port_opt(), use_seg=True, seed=3, **kw)
    tr.train(iterations, log_every=log_every, profile_dir=profile_dir,
             profile_iters=(1, 3))
    return tr


def self_ns(spans: list) -> list:
    """Each record's duration less its children's."""
    out = [s["end"] - s["start"] for s in spans]
    for s in spans:
        if s["parent"] is not None:
            out[s["parent"]] -= s["end"] - s["start"]
    return out


def test_off_keeps_nothing_and_on_trains_the_same(scene, monkeypatch):
    tracing.take()
    assert not tracing.enabled()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        assert tracing.span("iter", 1) is tracing.span("step.update")
        off = train(scene).model.params
    assert tracing.take()["spans"] == []
    tracing.on()
    try:
        on = train(scene).model.params
    finally:
        tracing.on(False)
    assert tracing.take()["spans"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_spans_of_each_iteration(scene, traced):
    train(scene, iterations=4, log_every=2, max_instances=1 << 14)
    spans = tracing.take()["spans"]
    assert min(self_ns(spans)) >= 0
    for it in range(1, 5):
        mine = [s for s in spans if s["iter"] == it]
        names = [s["name"] for s in mine]
        assert set(PARENTS) | {"composite.backward"} <= set(names), it
        assert ("iter.log" in names) == (it % 2 == 0)
        for s in mine:
            assert s["start"] <= s["end"]
            if s["parent"] is None:
                continue
            p = spans[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
            assert p["iter"] == it and p["thread"] == s["thread"]
            if s["name"] in PARENTS:
                assert p["name"] == PARENTS[s["name"]], s["name"]
        assert names.count("iter") == 1
        # the backward composite runs on the engine's thread on a card, on
        # the caller's here
        back = next(s for s in mine if s["name"] == "composite.backward")
        assert (back["parent"] is None
                or spans[back["parent"]]["name"] == "step.backward")


def test_host_syncs_count_the_values_read_back(scene, traced):
    before = tracing.counters()
    # the capacity autosize reads two values from each of four cameras (a
    # sync span each); the check at iteration 3 reads iteration 1's two,
    # after which the check interval is 10; the loss is read at iterations
    # 2 and 4
    tr = train(scene, iterations=4, log_every=2)
    after = tracing.counters()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert tr._check_interval == 10
    assert delta("host_syncs") == 4 * 2 + 2 + 2
    # and a sync span, uncounted, around the copies from the host that wait
    # for the device on a card: one in each preprocess (four of them the
    # autosize's), one in each binning
    syncs = [s for s in tracing.take()["spans"] if s["name"] == "sync"]
    assert len(syncs) == 4 + 1 + 2 + 4 + 4 * 2
    # one registry with the kernels' launch counts
    assert "composite_forward_packed_quad" in after


def test_spans_are_user_annotations_under_the_profiler(scene, traced,
                                                       tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(scene, iterations=2, log_every=2, max_instances=1 << 14)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {tracing.PREFIX + n for n in PARENTS} <= names
    # the Trainer's own profiler window turns tracing on for its length and
    # leaves it as it found it, dropping its records if it was off
    tracing.on(False)
    train(scene, iterations=3, log_every=2, max_instances=1 << 14,
          profile_dir=str(tmp_path))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    got = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"gsplat.iter", "gsplat.step.losses"} <= got
    assert not tracing.enabled() and tracing.take()["spans"] == []


def test_threads_keep_their_own_parents(traced):
    """Spans opened on several threads at once (the autograd engine's
    thread opens them beside the Trainer's) keep their parents and
    counts."""
    import sys
    import threading

    def work(k):
        for _ in range(200):
            with tracing.span(f"outer{k}"):
                with tracing.span(f"inner{k}"):
                    tracing.count("stress")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tracing.counters().get("stress", 0)
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tracing.take()["spans"]
    assert tracing.counters()["stress"] - before == 8 * 200
    assert len(spans) == 8 * 200 * 2
    for s in spans:
        if s["name"].startswith("inner"):
            p = spans[s["parent"]]
            assert p["name"] == "outer" + s["name"][5:]
            assert p["thread"] == s["thread"]
        else:
            assert s["parent"] is None
