"""clipa_tpu_torch.tracing: the spans' samples and flags, their ranges in a
CPU torch.profiler trace, the store's bound, and the spans that one
training step and one served request record (CPU, tiny sizes)."""

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from clipa_tpu_torch import optim, tracing
from clipa_tpu_torch.configs import clipa_pretrain
from clipa_tpu_torch.train import step

STEP_SPANS = ("train.step", "train.forward", "train.loss", "train.backward",
              "train.optim.update", "train.optim.apply", "train.norms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _refuse(*args, **kwargs):
    raise AssertionError("entered without a profiler recording")


def test_a_span_records_one_untraced_sample_per_exit():
    for _ in range(3):
        with tracing.span("t.a"):
            pass
    samples = tracing.recent("t.a")
    assert len(samples) == 3 and tracing.recent("t.a", profiled=True) == []
    assert all(s.duration_ns >= 0 and not s.profiled for s in samples)
    assert [s.start_ns for s in samples] == sorted(s.start_ns
                                                   for s in samples)
    assert tracing.recent("t.never") == []


def test_a_span_without_a_profiler_enters_no_range_and_no_device_work(
        monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    with tracing.span("t.outer"):
        with tracing.span("t.inner"):
            pass
    assert len(tracing.recent("t.outer")) == len(tracing.recent("t.inner")) \
        == 1


def test_a_span_under_the_profiler_is_a_range_inside_the_callers():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            with tracing.span("t.traced"):
                torch.ones(4).sum()
    with tracing.span("t.traced"):
        pass
    events = {e.name: e for e in prof.events()
              if e.name in ("caller", "t.traced")}
    assert set(events) == {"caller", "t.traced"}
    outer, inner = events["caller"].time_range, events["t.traced"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert [s.profiled for s in tracing.recent("t.traced", profiled=True)] \
        == [True]
    assert len(tracing.recent("t.traced")) == 1


def test_the_store_keeps_at_most_its_bound():
    for _ in range(tracing.BOUND + 10):
        with tracing.span("t.many"):
            pass
    with tracing.span("t.few"):
        pass
    assert len(tracing.recent("t.many")) == tracing.BOUND
    assert len(tracing.recent("t.few")) == 1


def _tiny_update(accum):
    config = clipa_pretrain.get_config(
        "img=Ti/16,res=96,token_len=8,batchsize=4")
    config.model.image.update(depth=1)
    config.model.text.update(depth=1, vocab_size=50)
    config.model.dtype = "float32"
    config.schedule = [(".*", dict(decay_type="const"))]
    config.grad_accum_steps = accum
    model = step.create_model(config, device="cpu")
    state = step.init_train_state(
        model, config, torch.Generator().manual_seed(0), "cpu")
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=3))
    update = step.make_update_fn(model, tx, config, total_steps=3)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randint(0, 256, (4, 96, 96, 3), generator=g,
                                    dtype=torch.uint8),
             "labels": torch.randint(1, 50, (4, 8), generator=g)}
    return update, state, batch


@pytest.mark.parametrize("accum", [1, 2])
def test_one_update_records_each_phase(accum):
    """One sample of each phase per step; under two-pass accumulation the
    forward's are pass 1 and each microbatch's live forward, and the loss's
    and the backward's one per microbatch. Every phase lies inside the
    step."""
    update, state, batch = _tiny_update(accum)
    tracing.clear()
    state, meas = update(state, batch)
    assert torch.isfinite(meas["training_loss"])
    counts = {name: len(tracing.recent(name)) for name in STEP_SPANS}
    per_micro = 1 if accum == 1 else accum
    assert counts == {"train.step": 1,
                      "train.forward": 1 if accum == 1 else 1 + accum,
                      "train.loss": per_micro, "train.backward": per_micro,
                      "train.optim.update": 1, "train.optim.apply": 1,
                      "train.norms": 1}
    whole = tracing.recent("train.step")[0]
    for name in STEP_SPANS[1:]:
        for s in tracing.recent(name):
            assert whole.start_ns <= s.start_ns
            assert s.start_ns + s.duration_ns <= (whole.start_ns
                                                  + whole.duration_ns)


def test_a_served_request_records_a_stage_and_a_drain_per_chunk(tmp_path):
    import json
    from clipa_tpu_torch.serving import EmbeddingService
    cfg = {"embed_dim": 16,
           "vision_cfg": {"image_size": 16, "layers": 1, "width": 32,
                          "head_width": 16, "patch_size": 8,
                          "gelu_approximate": "tanh", "ln_pre": False,
                          "pool_style": "big_vision_gap",
                          "global_average_pool": True},
           "text_cfg": {"context_length": 8, "vocab_size": 32, "width": 32,
                        "heads": 2, "layers": 1, "bert_tokenizer": True,
                        "gelu_approximate": "tanh",
                        "pool_style": "big_vision_last",
                        "attention_mask": False}}
    path = tmp_path / "Tiny-Spans.json"
    path.write_text(json.dumps(cfg))
    svc = EmbeddingService(str(path), None, precision="float32",
                           buckets=(4,), num_workers=0, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (10, 16, 16, 3),
                                               dtype=np.uint8)
    tracing.clear()
    z = svc.embed_images(images)
    assert z.shape == (10, 16)
    assert len(tracing.recent("serve.stage")) == 3     # 4 + 4 + 2 (padded)
    assert len(tracing.recent("serve.drain")) == 3
    assert tracing.recent("serve.pin") == []    # no pinned copy on the CPU


def _tiny_t5(remat):
    from clipa_tpu_torch.models import layers, t5_text
    model = t5_text.Model(16, width=32, depth=2, num_heads=4, head_dim=8,
                          mlp_dim=48, vocab_size=50, remat_policy=remat)
    layers.init_parameters(model, torch.Generator().manual_seed(0))
    ids = torch.randint(2, 50, (3, 6), generator=torch.Generator()
                        .manual_seed(1))
    ids[:, 4:] = 0
    return model, ids


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_the_t5_attention_spans_record_without_a_profiler(monkeypatch,
                                                           remat):
    """The T5 tower's cores: one ``t5.attention`` sample per block in the
    forward and one more per block in remat's recompute, one
    ``t5.attention.bwd`` per block, none entering a range."""
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    model, ids = _tiny_t5(remat)
    z, _ = model(ids)
    z.square().sum().backward()
    fwd = tracing.recent("t5.attention")
    bwd = tracing.recent("t5.attention.bwd")
    assert len(fwd) == (2 if remat == "none" else 4) and len(bwd) == 2
    assert not any(s.profiled for s in fwd + bwd)
    # each backward span starts after the forward's cores ended
    assert min(s.start_ns for s in bwd) >= fwd[1].start_ns + fwd[1].duration_ns


def test_the_t5_backward_span_holds_its_cores_backward():
    """Under the CPU profiler each core's softmax backward lies inside a
    ``t5.attention.bwd`` range, and the bias add's and the pad mask's too."""
    model, ids = _tiny_t5("minimal")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        z, _ = model(ids)
        z.square().sum().backward()
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "t5.attention.bwd"]
    inner = [e.time_range for e in events if e.name.startswith(
        "autograd::engine::evaluate_function: ") and any(
        k in e.name for k in ("SoftmaxBackward", "MaskedFillBackward"))]
    assert len(spans) == 2 and len(inner) == 4
    for t in inner:
        assert any(s.start <= t.start and t.end <= s.end for s in spans), t
    assert len([e for e in events if e.name == "t5.attention"]) == 4


@pytest.mark.cuda
def test_the_t5_attention_ranges_reach_the_device_timeline():
    """On the card, under a profiler, ``t5.attention`` (forward and
    recompute) and ``t5.attention.bwd`` are mirrored onto the device
    timeline over the kernels they launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, ids = _tiny_t5("minimal")
    model.cuda()
    ids = ids.cuda()
    z, _ = model(ids)      # warm-up outside the trace
    z.square().sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        z, _ = model(ids)
        z.square().sum().backward()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    mirrored = [e for e in prof.events() if e.device_type == cuda
                and e.is_user_annotation]
    names = [e.name for e in mirrored]
    assert names.count("t5.attention") == 4, names
    assert names.count("t5.attention.bwd") == 2, names
    kernels = [e.time_range for e in prof.events() if e.device_type == cuda
               and not e.is_user_annotation]
    for e in mirrored:
        if e.name.startswith("t5.attention"):
            r = e.time_range
            assert any(r.start <= k.start and k.end <= r.end
                       for k in kernels), e.name
