"""clipa_tpu_torch.tools: the profile summary's arithmetic (the trace itself
needs a card; see tools/profile_service.py), the ablation ladder on the CPU
against the JAX tool's keys, the FLOP count against the JAX tool's, the
Chrome-trace summary on a synthetic trace, ``bench_pipeline`` (the shards
it writes and ``measure``'s keys, against the JAX tool's) and ``laion``
(``count``, ``convert-webdataset``, ``rename`` and ``smoke`` against the
JAX tool's on a tar the test writes; URLs refused)."""

import inspect
import json
import re

import numpy as np
import pytest
import torch

from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.tools import ablate_step as jax_ablate_step
from clipa_tpu.tools import bench_pipeline as jax_bench_pipeline
from clipa_tpu.tools import flops as jax_flops
from clipa_tpu.tools import laion as jax_laion
from clipa_tpu_torch.models import two_towers
from clipa_tpu_torch.ops import attention, block_attention
from clipa_tpu_torch.tools import (ablate_step, bench_pipeline, flops, laion,
                                   profile_service, trace_summary)


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),                 # overlap counted once
    ([(5, 6), (0, 2), (5.5, 5.7)], 3.0),     # unsorted, nested
    ([(0, 1), (1, 2)], 2.0),                 # touching
])
def test_union_of_device_intervals(intervals, total):
    assert profile_service.union_us(intervals) == total


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::fused_attention_fwd_kernel<80, 96>",
     "attention kernel"),
    ("void (anonymous namespace)::attention_bwd_dkv_kernel<64>(...)",
     "attention bwd kernel"),
    ("void (anonymous namespace)::column_sum_kernel(...)",
     "attention bwd kernel"),
    ("void (anonymous namespace)::attention_bwd_dq_kernel<64, true>(...)",
     "attention bwd kernel"),
    ("void (anonymous namespace)::patch_embed_kernel<__nv_bfloat16>(...)",
     "patch embed kernel"),
    ("void (anonymous namespace)::flash_attention_fwd_kernel<64>(...)",
     "flash attention kernel"),
    ("void (anonymous namespace)::flash_attention_dq_kernel<64>(...)",
     "flash attention bwd kernel"),
    ("void (anonymous namespace)::flash_attention_dkv_kernel<80>(...)",
     "flash attention bwd kernel"),
    ("void (anonymous namespace)::flash_attention_bwd_fused_kernel<64>(...)",
     "flash attention bwd kernel"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "gemm"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float>", "layernorm"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "GeluCUDAKernelImpl>", "gelu"),
    ("Memcpy HtoD (Pinned -> Device)", "host<->device copy"),
    ("void at::native::reduce_kernel<512, 1>", "other"),
])
def test_kernel_families(name, fam):
    assert profile_service.family(name) == fam


# --- the tools slice: ablate_step, flops, trace_summary --------------------

TINY_ABLATION = ["--batch", "2", "--res", "112", "--tokens", "8",
                 "--variant", "Ti/16", "--iters", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def ablation():
    """The ladder at Ti/16 @112 (L = 50: the fused path's plain versions)
    on the CPU, one timed call per rung, the triad over 1 MB."""
    torch.manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ablate_step, "TRIAD_MB", 1)
        return ablate_step.main(TINY_ABLATION)


def test_ablate_step_has_the_reference_keys(ablation):
    """The same JSON keys as clipa_tpu/tools/ablate_step.py, all finite."""
    source = inspect.getsource(jax_ablate_step)
    want = set(re.findall(r'results\["(\w+)"\]', source))
    results, launches = ablation
    assert set(results) == want
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    assert set(launches) == want - {"hbm_triad_gbps"}
    # a CPU run launches no kernel (plain versions)
    assert all(n == 0 for rung in launches.values()
               for c, n in rung.items() if c != "bypassed")
    # only grad_noattn runs the stand-in core: per call, one per layer of
    # the Ti/16 image tower (12) and of the Ti text tower (12), over the
    # two warm-up calls and the one timed
    assert {k: r["bypassed"] for k, r in launches.items()} == {
        k: 3 * 24 if k == "grad_noattn_ms" else 0 for k in launches}


def test_grad_noattn_bypasses_attention(monkeypatch):
    """Under no_attention() no attention core runs (neither the einsum
    path nor the fused path's plain version), and the query and key
    projections get no gradient."""
    calls = []
    einsum = attention._einsum_attention
    plain = block_attention.attention_plain
    monkeypatch.setattr(attention, "_einsum_attention",
                        lambda *a: calls.append("einsum") or einsum(*a))
    monkeypatch.setattr(block_attention, "attention_plain",
                        lambda *a, **kw: calls.append("fused")
                        or plain(*a, **kw))
    args = ablate_step.argparse.Namespace(variant="Ti/16", res=112, tokens=8)
    images = torch.randint(0, 255, (2, 112, 112, 3), dtype=torch.uint8)
    labels = torch.randint(0, 32000, (2, 8), dtype=torch.int32)
    monkeypatch.setattr(ablate_step.no_attention, "calls", 0)
    with ablate_step.no_attention():
        model = ablate_step.build(args, torch.device("cpu"), "einsum")
        params, grad = ablate_step._grad_fn(model, images, labels)
        grads = dict(zip([n for n, p in model.named_parameters()
                          if p.requires_grad], grad()))
    assert calls == []
    # the stand-in ran once per layer of both towers
    assert ablate_step.no_attention.calls == 24
    qk = [n for n in grads if ".query." in n or ".key." in n]
    assert qk and all(grads[n] is None for n in qk)
    # and outside the context the same model does run attention
    ablate_step._grad_fn(model, images, labels)[1]()
    assert calls and set(calls) == {"einsum"}


def test_flops_match_the_jax_tool():
    """flops.analyze on a Ti/16 two-tower model at 64 px, 8 tokens,
    batch 2: the parameter count is exact; the forward's GFLOPs within 10%
    of XLA's cost analysis (which also counts elementwise work; measured
    here 0.548 vs 0.554)."""
    jax_model = jax_two_towers.Model(
        image={"variant": "Ti/16", "pool_type": "gap",
               "posemb": "sincos2d"},
        text={"variant": "Ti", "pool_type": "last", "vocab_size": 32000},
        out_dim=512, temperature_init=1 / 0.07)
    want = jax_flops.analyze(jax_model, (2, 64, 64, 3), (2, 8))
    with torch.device("meta"):
        model = two_towers.Model(
            image={"variant": "Ti/16", "pool_type": "gap",
                   "posemb": "sincos2d", "image_size": (64, 64)},
            text={"variant": "Ti", "pool_type": "last", "vocab_size": 32000,
                  "context_length": 8},
            out_dim=512, temperature_init=1 / 0.07)
    got = flops.analyze(model, (2, 64, 64, 3), (2, 8))
    assert got["params_m"] == want["params_m"]
    assert abs(got["fwd_gflops"] / want["fwd_gflops"] - 1) < 0.1
    assert got["bytes_accessed_mb"] is None


def test_flops_cli_on_the_serving_model():
    stats = flops.main(["--model", "ViT-H-14-CL32-GAP-BigVision"])
    assert 900 < stats["params_m"] < 1000 and stats["fwd_gflops"] > 300


def _event(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def test_trace_summary_of_a_synthetic_trace(tmp_path):
    """Two marked steps over [0, 100) us; device work: an attention kernel
    (10 + 10 us), a GEMM overlapping it (5 us, of which 3 alone), a memcpy
    (4 us) and a kernel past the window (not counted); the host ops and the
    device-lane mirror of an annotation are not device work."""
    events = [
        _event("ProfilerStep#0", "user_annotation", 0, 50),
        _event("ProfilerStep#1", "user_annotation", 50, 50),
        _event("ProfilerStep#1", "gpu_user_annotation", 50, 50),
        _event("aten::mm", "cpu_op", 0, 90),
        _event("void attention_bwd_dq_kernel<64, false>(...)", "kernel",
               10, 10),
        _event("nvjet_tst_128x64", "kernel", 18, 5),
        _event("void fused_attention_fwd_kernel<64>(...)", "kernel", 60, 10),
        _event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 80, 4),
        _event("void patch_embed_kernel<float>(...)", "kernel", 120, 5),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace_summary.summarize(str(path))
    assert out["steps_detected"] == 2 and out["steps_divisor"] == 2
    fams = out["by_family_per_step"]
    assert fams["attention bwd kernel"]["ms"] == 0.005
    assert fams["attention kernel"]["ms"] == 0.005
    assert fams["gemm"]["ms"] == 0.0025
    assert fams["host<->device copy"]["ms"] == 0.002
    assert "patch embed kernel" not in fams
    assert out["device_ms_per_step"] == 0.0145
    assert out["busy_share"] == (10 + 3 + 10 + 4) / 100
    assert sum(f["share"] for f in fams.values()) == pytest.approx(1.0)
    assert trace_summary.summarize(str(path), steps=1)[
        "device_ms_per_step"] == 0.029


def test_bench_pipeline_shards_and_measure_keys(tmp_path):
    """The same shard bytes as the JAX tool (same seed, PIL encoder and
    record layout); ``measure`` on threads and on worker processes returns
    the JAX tool's keys."""
    import glob
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    pattern = bench_pipeline.make_jpeg_shards(str(ours), 16, 48, shards=2)
    jax_bench_pipeline.make_jpeg_shards(str(ref), 16, 48, shards=2)
    assert pattern == str(ours / "*.tfrecord")
    names = sorted(p.rsplit("/", 1)[1] for p in glob.glob(pattern))
    assert names == ["bench-00000.tfrecord", "bench-00001.tfrecord"]
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes()
    # captions in turn
    bench_pipeline.make_jpeg_shards(str(tmp_path), 4, 16, shards=1,
                                    captions=["one", "two"])
    from clipa_tpu_torch.data import tfrecord
    txts = [tfrecord.parse_example(r)["txt"] for r in tfrecord.read_records(
        str(tmp_path / "bench-00000.tfrecord"))]
    assert [bytes(t[0]) if isinstance(t, list) else bytes(t)
            for t in txts] == [b"one", b"two", b"one", b"two"]
    pp = ('decode_jpeg_and_inception_crop(inkey="jpg", size=16)|'
          'keep("image")')
    for processes in (False, True):
        r = bench_pipeline.measure(pattern, pp, 2, 4, 0.2,
                                   processes=processes)
        assert set(r) == {"num_workers", "mode", "samples_per_sec",
                          "batches"}
        assert r["mode"] == ("processes" if processes else "threads")
        assert r["samples_per_sec"] > 0 and r["batches"] >= 1


def _webdataset_tar(path, n=5):
    import io
    import tarfile
    from PIL import Image
    rng = np.random.RandomState(0)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (12, 10, 3), np.uint8)).save(
                buf, "JPEG")
            parts = {"jpg" if i % 2 else "jpeg": buf.getvalue(),
                     "txt": f"caption {i}".encode(), "json": b"{}"}
            if i == 3:
                parts.pop("txt")
            if i == 4:   # no image: skipped
                parts = {"txt": b"orphan"}
            for ext, data in parts.items():
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("verify", [False, True])
def test_laion_convert_and_count_match_the_jax_tool(tmp_path, capsys,
                                                    verify):
    for i in range(2):
        _webdataset_tar(str(tmp_path / f"shard-{i}.tar"))
    outs = {}
    for name, tool in (("ours", laion), ("ref", jax_laion)):
        out = tmp_path / name
        tool.main(["convert-webdataset", "--pattern",
                   str(tmp_path / "shard-*.tar"), "--out-dir", str(out)])
        tool.main(["count", "--pattern", str(out / "*.tfrecord*")]
                  + (["--verify"] if verify else []))
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert outs["ours"] == outs["ref"]
    info = json.loads(outs["ours"]["dataset_info.json"])
    assert info["splits"][0]["shardLengths"] == ["4", "4"]
    assert info["totalExamples"] == 8
    capsys.readouterr()
    laion.main(["smoke", "--pattern", str(tmp_path / "ours" / "*.tfrecord*"),
                "-n", "2"])
    jax_laion.main(["smoke", "--pattern",
                    str(tmp_path / "ref" / "*.tfrecord*"), "-n", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == lines[2:] and len(lines) == 4


def test_laion_rename_and_urls(tmp_path, capsys):
    for i in range(3):
        (tmp_path / f"part{i}.tfrecord").write_bytes(b"")
    laion.main(["rename", "--pattern", str(tmp_path / "part*"),
                "--dry-run"])
    jax_laion.main(["rename", "--pattern", str(tmp_path / "part*"),
                    "--dry-run"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == lines[3:]
    laion.main(["rename", "--pattern", str(tmp_path / "part*"),
                "--name", "ds"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"ds-full.tfrecord-0000{i}-of-00003" for i in range(3)]
    for argv in (["count", "--pattern", "gs://bucket/*.tfrecord"],
                 ["convert-webdataset", "--pattern", str(tmp_path / "x"),
                  "--out-dir", "s3://bucket/out"]):
        # the tool reads and writes local files only, as the JAX tool's glob
        with pytest.raises(NotImplementedError, match="local path"):
            laion.main(argv)
    with pytest.raises(SystemExit, match="no files match"):
        laion.main(["count", "--pattern", str(tmp_path / "nothing*")])


@pytest.mark.parametrize("kernels", ["patch,deferred", "patch", "deferred",
                                     "fused,flash,patch,deferred"])
def test_flash_bench_takes_the_kernel_sets_and_needs_a_card(
        monkeypatch, capsys, kernels):
    """tools/flash_bench.py --kernels parses the patch embed and deferred
    backward sets beside fused and flash, then refuses to run without a
    card (exit 1, nothing timed)."""
    from clipa_tpu_torch.tools import flash_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_bench.main(["--kernels", kernels]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


@pytest.mark.parametrize("kernels", ["patch,sweep", "", "conv"])
def test_flash_bench_refuses_unknown_kernel_sets(kernels):
    from clipa_tpu_torch.tools import flash_bench
    with pytest.raises(SystemExit):
        flash_bench.main(["--kernels", kernels])


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::patch_gemm_kernel<__nv_bfloat16>("
     "CUtensorMap_st, CUtensorMap_st, float const*, __nv_bfloat16*, int)",
     "patch_gemm_kernel<__nv_bfloat16>"),
    ("void (anonymous namespace)::split_kernel(float const*, "
     "__nv_bfloat16*, int, int, int)", "split_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctorOnSelf_add<float>, std::array<char*, 2ul> >("
     "int, at::native::CUDAFunctorOnSelf_add<float>, "
     "std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel<4, CUDAFunctorOnSelf_add<float>, std::ar"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD "),
])
def test_chip_smoke_kernel_names_drop_arguments_and_namespaces(name, short):
    """chip_smoke's per-kernel device breakdown keys each kernel by its
    name without arguments, return type and namespaces (70 characters at
    most)."""
    from clipa_tpu_torch.tools import flash_bench
    assert flash_bench._chip_smoke()._kernel_name(name) == short
