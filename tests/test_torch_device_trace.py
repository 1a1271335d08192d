"""The port's device-trace reader and per-kernel attribution
(``paddle_tpu_torch/utils/profile_data.py``, ``utils/device_trace.py``)
and the launch costs (``ops/kernel_costs.py``): the interval arithmetic
against the JAX package's functions on seeded random interval sets, the
chrome-trace join on synthetic CUDA captures, the costs recorded by the
kernel wrappers, and the overlap core against the reference's and over
a 2-rank gloo step."""
import json
import random

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from paddle_tpu.parallel import comm_opt as JC
from paddle_tpu.utils import device_trace as JDT
from paddle_tpu_torch.ops import cuda_kernels as CK
from paddle_tpu_torch.ops import kernel_costs as KC
from paddle_tpu_torch.parallel import comm_opt as C
from paddle_tpu_torch.utils import device_trace as DT
from paddle_tpu_torch.utils.profile_data import ProfileData


# ---------------------------------------------------------------------------
# (a) the interval arithmetic: the reference's, as it is
# ---------------------------------------------------------------------------

def _lines(seed):
    """Seeded random lines of events: nested spans on each line, lines
    overlapping one another."""
    rng = random.Random(seed)
    lines = []
    for li in range(rng.randint(1, 4)):
        evs, t = [], rng.uniform(0, 50)
        for i in range(rng.randint(1, 12)):
            start = t + rng.uniform(0, 20)
            dur = rng.uniform(1, 60)
            evs.append([start, dur, f"line{li}", f"op{li}.{i}"])
            # a nested child now and then
            if rng.random() < 0.4:
                evs.append([start + dur * 0.2, dur * 0.5, f"line{li}",
                            f"child{li}.{i}"])
            t = start + rng.uniform(0, dur * 1.2)
        lines.append(evs)
    return lines


@pytest.mark.parametrize("seed", range(8))
def test_interval_arithmetic_equals_reference(seed, capsys):
    lines = _lines(seed)
    mine = [DT._exclusive_segments([list(r) for r in ln]) for ln in lines]
    ref = [JDT._exclusive_segments([list(r) for r in ln]) for ln in lines]
    assert mine == ref
    rows_m = [r for ln in mine for r in ln]
    rows_r = [r for ln in ref for r in ln]
    assert DT._check_busy_le_wall(rows_m, "p") == \
        JDT._check_busy_le_wall(rows_r, "p")
    assert DT._union_rows(rows_m) == JDT._union_rows(rows_r)
    # the attributed total is the union of the segments
    union = DT.busy_ns((r[0], r[0] + r[1]) for r in rows_m)
    assert sum(r[6] for r in rows_m) == pytest.approx(union, rel=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_overlap_core_equals_reference(seed):
    rng = random.Random(100 + seed)

    def ivs(n):
        out = []
        for _ in range(n):
            s = rng.uniform(0, 1e6)
            out.append((s, s + rng.uniform(1, 2e5)))
        return out

    coll, comp = ivs(rng.randint(1, 9)), ivs(rng.randint(0, 9))
    assert C._merge_intervals(coll) == JC._merge_intervals(coll)
    cm, pm = JC._merge_intervals(coll), JC._merge_intervals(comp)
    assert C._intersect_total(cm, pm) == JC._intersect_total(cm, pm)
    got = C.overlap_fraction(coll, comp, "gloo_staged")
    tot = sum(e - s for s, e in cm)
    ov = JC._intersect_total(cm, pm)
    assert got["overlap_fraction"] == ov / tot
    assert got["collective_ms"] == tot / 1e6
    assert got["exposed_ms"] == (tot - ov) / 1e6
    assert 0.0 <= got["overlap_fraction"] <= 1.0
    assert C.overlap_fraction([], comp, "gloo_staged") is None


# ---------------------------------------------------------------------------
# synthetic CUDA captures: the reader and the join
# ---------------------------------------------------------------------------

PID, TID = 4242, 4242


def _op(name, ts, dur, ext, flops=None, cat="cpu_op"):
    args = {"External id": ext}
    if flops:
        args["flops"] = flops
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": TID,
            "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, ext, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": PID,
            "tid": TID, "ts": ts, "dur": 2.0,
            "args": {"correlation": corr, "External id": ext}}


def _kernel(name, ts, dur, corr, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
            "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": stream, "correlation": corr}}


FWD = "void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64, {}>"\
      "((anonymous namespace)::Args)"
SPLIT = ("void ptt::decode::decode_split_kernel<__nv_bfloat16, __nv_bfloat16,"
         " 64, true, (anonymous namespace)::PagedRows>(int)")
MERGE = ("void ptt::decode::decode_merge_kernel<__nv_bfloat16, 64, "
         "(anonymous namespace)::PagedRows>(float const*)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas"


def _trace():
    """A step on one stream: a linear (one gemm, its op's FLOPs), two
    flash forwards (bias-free, then the bias form) under the custom op,
    a paged decode (split pass and merge) and a memcpy."""
    ev = [
        {"ph": "M", "name": "thread_name", "pid": PID, "tid": TID,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "train_step",
         "pid": PID, "tid": TID, "ts": 1000.0, "dur": 500.0,
         "args": {"External id": 1}},
        _op("aten::linear", 1010.0, 30.0, 2),
        _op("aten::addmm", 1012.0, 20.0, 3, flops=2 * 16 * 32 * 64),
        _launch(1015.0, 101, 3),
        _op("paddle_tpu_torch::flash_fwd", 1050.0, 20.0, 4),
        _launch(1055.0, 102, 4),
        _op("paddle_tpu_torch::flash_fwd", 1080.0, 20.0, 5),
        _launch(1085.0, 103, 5),
        _launch(1110.0, 104, 1),
        _launch(1112.0, 105, 1),
        _op("aten::copy_", 1120.0, 10.0, 6),
        _launch(1121.0, 106, 6, "cudaMemcpyAsync"),
        _kernel(GEMM, 1020.0, 40.0, 101),
        _kernel(FWD.format("false"), 1060.0, 30.0, 102),
        _kernel(FWD.format("true"), 1090.0, 35.0, 103),
        _kernel(SPLIT, 1130.0, 20.0, 104),
        _kernel(MERGE, 1150.0, 5.0, 105),
        _kernel("Memcpy HtoD (Pageable -> Device)", 1160.0, 4.0, 106,
                cat="gpu_memcpy"),
        # the profiler's mirror of a record_function range: an envelope
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step",
         "pid": 0, "tid": 7, "ts": 1020.0, "dur": 150.0,
         "args": {"device": 0, "stream": 7}},
    ]
    return {"traceEvents": ev, "schemaVersion": 1}


def _costs(order=("flash_fwd", "flash_fwd_bias", "decode_paged")):
    lc = KC.LaunchCosts()
    fns = {"flash_fwd": (KC.flash_fwd, (2, 16, 2, 64, 2, True)),
           "flash_fwd_bias": (KC.flash_fwd, (2, 16, 2, 64, 2, False, 32)),
           "decode_paged": (KC.decode_paged, (
               np.array([[1, 2], [3, 4]], np.int32),
               torch.tensor([5, 20], dtype=torch.int32), 2, 64, 2, 16))}
    for name in order:
        fn, args = fns[name]
        lc.add(name, fn, *args)
    return lc


def test_profile_data_planes_lines_events(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(_trace()))
    pd = ProfileData.from_trace_dir(str(tmp_path))
    names = [p.name for p in pd.planes]
    assert names == ["/host:CPU", "/device:GPU:0"]
    dev = pd.device_planes()[0]
    (line,) = list(dev.lines)
    assert line.name == "stream 7"
    first = line.events[1]              # after the envelope that holds it
    assert first.start_ns == 1020000 and first.duration_ns == 40000
    assert dict(first.stats)["correlation"] == 101
    (host_line,) = list(pd.host_plane().lines)
    assert host_line.name.startswith("python")


def test_kernel_rows_join_pairs_and_folds(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(_trace()))
    lc = _costs()
    rows, source = DT.kernel_rows(str(tmp_path), steps=1, costs=lc)
    assert source == "device_streams"
    by = {r["name"]: r for r in rows}
    # the gemm: its launching op's FLOPs, a matrix product, its scope
    gemm = by[GEMM]
    assert gemm["op_name"] == f"train_step/aten::linear/aten::addmm/{GEMM}"
    assert gemm["flops"] == 2 * 16 * 32 * 64 and gemm["opcode"] == "dot"
    assert gemm["bytes"] is None
    # the bias form told apart from the bias-free one by launch order
    c = dict(lc.resolve())
    assert by["flash_fwd"]["flops_total"] == c["flash_fwd"].flops
    assert by["flash_fwd_bias"]["bytes_total"] == c["flash_fwd_bias"].nbytes
    assert by["flash_fwd_bias"]["op_name"].endswith(
        "paddle_tpu_torch::flash_fwd/flash_fwd_bias")
    # the merge pass folds into its launch: one event, both kernels' time
    dp = by["decode_paged"]
    assert dp["events"] == 1 and dp["ns"] == 25000.0
    assert dp["flops_total"] == c["decode_paged"].flops
    assert "Memcpy HtoD (Pageable -> Device)" in by
    # the envelope is never summed: rows add up to the busy union
    busy = DT.busy_ns([(1020e3, 1060e3), (1060e3, 1090e3),
                       (1090e3, 1125e3), (1130e3, 1155e3),
                       (1160e3, 1164e3)])
    assert sum(r["ns"] for r in rows) == pytest.approx(busy)
    ops = {r["op"]: r for r in DT.measured_op_rows(str(tmp_path))}
    assert ops["aten::addmm"]["device_ns"] == 40000


def test_rows_keep_the_capture_range(tmp_path):
    """A capture's warm-up runs before its ``paddle_capture`` range: its
    events leave the rows, and a warm-up launch the profiler lost is not
    counted as unanswered."""
    doc = _trace()
    doc["traceEvents"].append(
        {"ph": "X", "cat": "user_annotation", "name": DT.CAPTURE_RANGE,
         "pid": PID, "tid": TID, "ts": 1040.0, "dur": 200.0,
         "args": {"External id": 9}})
    doc["traceEvents"].append(_launch(1016.0, 107, 3))   # lost, warm-up
    pd = ProfileData.from_json(doc)
    rows, _ = DT.kernel_rows(pd, costs=_costs())
    names = {r["name"] for r in rows}
    assert GEMM not in names and "flash_fwd" in names
    assert DT.unanswered_launches(pd) == []
    doc["traceEvents"].append(_launch(1100.0, 108, 1))   # lost, in range
    assert [e.stat("correlation") for e in DT.unanswered_launches(
        ProfileData.from_json(doc))] == [108]


def test_unpaired_port_kernels_raise(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(_trace()))
    # one flash launch recorded for two flash events
    with pytest.raises(DT.AttributionError, match="flash_fwd"):
        DT.kernel_rows(str(tmp_path), costs=_costs(
            ("flash_fwd", "decode_paged")))
    # a recorded launch whose kernel left no event
    lc = _costs()
    lc.add("logits_head", KC.logits_head, 8, 768, 50304, 2)
    with pytest.raises(DT.AttributionError, match="logits_head"):
        DT.kernel_rows(str(tmp_path), costs=lc)


def test_kernel_entries_and_base_names():
    assert CK.kernel_entries(FWD.format("true")) == (
        ("flash_fwd", "flash_fwd_bias"), False)
    assert CK.kernel_entries(MERGE) == (("decode_paged",), True)
    assert CK.kernel_entries("void (anonymous namespace)::ln_bwd_kernel_"
                             "finalize(float const*)") == (
        ("fused_ln_bwd",), True)
    assert CK.kernel_entries("void (anonymous namespace)::adam_kernel("
                             "float*)")[0] == ("opt_adam", "opt_adamw")
    assert CK.kernel_entries("void (anonymous namespace)::adamw_flat_kernel"
                             "<float>(float*)")[0] == ("opt_adamw_flat",)
    assert CK.kernel_entries(GEMM) == ((), False)
    # every entry names a symbol
    assert all(meta.get("symbols") for meta in CK.KERNELS.values())
    assert DT.kernel_base(FWD.format("false")) == "flash_fwd_kernel"
    assert DT.kernel_base(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int, at::"
        "native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)") == \
        "at::native::vectorized_elementwise_kernel"


# ---------------------------------------------------------------------------
# the launch costs: the formulas chip_smoke.py printed its bounds from
# ---------------------------------------------------------------------------

def test_kernel_costs_keep_the_printed_bounds():
    B, D, V, L = 8, 768, 50304, 12
    assert KC.fused_ln(B, D, 2, stats=False)[:2] == (
        8 * B * D, 2 * B * D * 2 + 2 * D * 4)
    R = 16384
    assert KC.fused_ln(R, D, 2, residual=True, bias_add=True)[:2] == (
        10 * R * D, 4 * R * D * 2 + D * 2 + 2 * D * 4 + 2 * R * 4)
    assert KC.fused_ln(R, D, 2)[:2] == (
        8 * R * D, 2 * R * D * 2 + 2 * D * 4 + 2 * R * 4)
    assert KC.fused_ln_bwd(R, D, 2, dsx=True)[:2] == (
        14 * R * D, 4 * R * D * 2 + 2 * R * 4 + 3 * D * 4)
    assert KC.fused_ln_bwd(R, D, 2)[:2] == (
        13 * R * D, 3 * R * D * 2 + 2 * R * 4 + 3 * D * 4)
    assert KC.logits_head(B, D, V, 2) == (
        2 * B * D * V + 8 * B * D,
        B * D * 2 + 2 * D * 4 + D * V * 2 + B * V * 2, "bf16")
    Bt, T, nh, hd = 16, 1024, 12, 64
    act, lse = Bt * T * nh * hd * 2, Bt * nh * T * 4
    pairs = Bt * nh * T * (T + 1) // 2
    assert KC.flash_fwd(Bt, T, nh, hd, 2) == (
        2 * hd * 2 * pairs, 4 * act + lse, "bf16")
    assert KC.flash_bwd_dq(Bt, T, nh, hd, 2)[:2] == (
        2 * hd * 3 * pairs, 6 * act + lse)
    assert KC.flash_bwd_dkv(Bt, T, nh, hd, 2)[:2] == (
        2 * hd * 4 * pairs, 6 * act + 2 * lse)
    Be, Te = 48, 512
    acte, lsee = Be * Te * nh * hd * 2, Be * nh * Te * 4
    assert KC.flash_fwd(Be, Te, nh, hd, 2, False, Be * Te)[:2] == (
        2 * hd * 2 * Be * nh * Te * Te, 4 * acte + lsee + Be * Te * 4)
    assert KC.ce_fwd(2048, D, 50304, 2) == (
        2 * 2048 * D * 50304,
        2048 * D * 2 + D * 50304 * 2 + 2048 * 4 + 2 * 2048 * 4, "bf16")
    n = 163_109_376
    assert KC.opt_adamw_flat(n, 2)[:2] == (18 * n, n * (16 + 8))
    assert KC.opt_sgd(n)[:2] == (2 * n, 12 * n)
    assert KC.opt_momentum(n)[:2] == (4 * n, 20 * n)
    assert KC.opt_adam(n, True)[:2] == (14 * n, 28 * n)
    # decode: the rows each lane's data needs
    pos = np.array([3, 0, 17], np.int32)
    act_l = np.array([1, 0, 1], np.int32)
    rows = int((pos + 1).sum())
    assert KC.decode_slab(pos, act_l, nh, hd, 2) == (
        rows * nh * (4 * hd + 3),
        3 * 3 * nh * hd * 2 + 2 * rows * nh * hd * 2
        + 2 * 2 * nh * hd * 2 + 3 * nh * hd * 2 + 2 * 3 * 4, "f32")
    tab = np.array([[1, 2], [1, 3], [0, 0]], np.int32)
    pos = np.array([17, 3, 0], np.int32)
    distinct = len({(int(tab[b, j // 16]), j % 16) for b in range(3)
                    for j in range(int(pos[b]) + 1)})
    got = KC.decode_paged(tab, pos, nh, hd, 2, 16)
    assert got.nbytes == (3 * 3 * nh * hd * 2 + 2 * distinct * nh * hd * 2
                          + 2 * 3 * nh * hd * 2 + 3 * nh * hd * 2 + 3 * 4
                          + int((pos // 16 + 1).sum()) * 4)


class _FakeLib:
    """A kernel library whose every entry point succeeds: the wrappers'
    card branch runs on CPU tensors, with nothing launched."""

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(CK, "_on_card", lambda *ts: True)
    monkeypatch.setattr(CK, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(CK, "_stream", lambda t: None)
    monkeypatch.setattr(CK, "_num_sms", lambda dev: 132)
    CK.reset_launches()
    yield
    CK.reset_launches()


def test_wrappers_record_launch_costs_only_while_armed(fake_card):
    from paddle_tpu_torch.ops import chunked_ce as CE
    from paddle_tpu_torch.ops import flash_attention as FA
    from paddle_tpu_torch.ops import fused_ln as FL

    R, D = 6, 64
    x = torch.randn(R, D)
    w, b = torch.ones(D), torch.zeros(D)
    q = torch.randn(2, 16, 2, 16)
    head, labels = torch.randn(D, 128), torch.zeros(R, dtype=torch.long)
    p, g = torch.zeros(100), torch.zeros(100)

    def calls():
        FL.fused_ln_fwd(x, w, b, residual=x, stats=False)
        FL.fused_ln_bwd(x, torch.zeros(R), torch.ones(R), w, x, dsx=x)
        FA.flash_fwd(q, q, q)
        CE.ce_fwd(x, head, None, labels, 128, 120)
        CK.fused_logits_head(x, w, b, head)
        CK.megakernel_adamw_flat(p, g, p.clone(), p.clone(), p.clone(),
                                 1e-3, 1.0, 1.0, 1.0)
        CK.megakernel_sgd(p, g, 0.1)

    calls()                                  # unarmed: nothing recorded
    assert CK.CAPTURE is None
    with KC.arm() as outer:
        with KC.arm() as inner:
            calls()
        calls()
    assert CK.CAPTURE is None
    tot = inner.totals()
    want = {"fused_ln": KC.fused_ln(R, D, 4, residual=True, stats=False),
            "fused_ln_bwd": KC.fused_ln_bwd(R, D, 4, dsx=True),
            "flash_fwd": KC.flash_fwd(2, 16, 2, 16, 4, True),
            "ce_fwd": KC.ce_fwd(R, D, 120, 4),
            "logits_head": KC.logits_head(R, D, 128, 4),
            "opt_adamw_flat": KC.opt_adamw_flat(100, 4),
            "opt_sgd": KC.opt_sgd(100, 4)}
    assert set(tot) == set(want)
    for k, c in want.items():
        assert tot[k] == {"launches": 1, "flops": c.flops,
                          "bytes": c.nbytes}, k
    # nested captures: the outer one sees both blocks' launches
    assert {k: v["launches"] for k, v in outer.totals().items()} == \
        dict.fromkeys(want, 2)
    assert CK.LAUNCHES["fused_ln"] == 3


# ---------------------------------------------------------------------------
# (i) the overlap of a 2-rank gloo step
# ---------------------------------------------------------------------------

def test_measure_overlap_fraction_gloo_step(tmp_path):
    """A dp-2 train step over gloo on the CPU, traced on each rank: the
    staged all-reduces are the collectives (``gloo_staged``); the share
    compute overlaps lies in [0, 1]."""
    res = W.spawn(W.overlap_worker, 2, {"num_layers": 1},
                  str(tmp_path / "overlap"), out_dir=str(tmp_path / "w"))
    for r, ov in enumerate(res):
        assert ov["source"] == "gloo_staged"
        assert 0.0 <= ov["overlap_fraction"] <= 1.0
        assert ov["collective_ms"] > 0 and ov["compute_ms"] > 0
        # the same number read again from the rank's capture
        assert C.measure_overlap_fraction(
            str(tmp_path / "overlap" / f"rank{r}")) == ov
    # a capture with no collective gives None, as the reference's does
    with DT.capture(str(tmp_path / "solo")):
        torch.ones(4).sum()
    assert C.measure_overlap_fraction(str(tmp_path / "solo")) is None
    assert C.measure_overlap_fraction(str(tmp_path / "none")) is None
