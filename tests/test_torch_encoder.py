"""The static-graph transformer encoder in the port against
``paddle_tpu``'s, on the CPU.

- ``multihead_matmul``: Out and the gradients of Input, W and Bias
  against the JAX lowering, with BiasQK none, [B, nh, S, S] and
  [B, 1, 1, S] (a padding bias), and a bias the flash kernels cannot
  take ([1, nh, S, S] at B 2): within 2e-6 / 5e-6 of their scale, the
  bands of ``test_torch_fluid_ops``. On CPU tensors both packages take
  the naive einsum-softmax path; the card's flash route is held to it in
  ``test_torch_cuda.py``.
- ``transformer_encoder_classifier`` trains like
  ``tests/test_transformer_encoder.py``: its program has the reference's
  desc, and 5 float32 Adam steps, each from the JAX state before it, give
  losses within 1e-5 relative and every persistable within 1e-5 of its
  scale (the larger of its largest |value| and lr, which a bias that
  starts at 0 moves by), the Adam moments included, but for the
  parameter elements whose gradient sits at its noise floor (below 1e-4
  of its tensor's largest: the K bias's, which attention cancels, and a
  few others). Adam divides each gradient element by its own root mean
  square, so there the step follows the rounding of the gradient (up to
  lr) in both packages: such elements are held within 2 lr (the rest
  measured at most 4.4e-6 of their scale). Run freely
  instead, the trajectories part by 3.4e-5 of a parameter's scale by
  step 3 as such elements carry. The same with a padding bias, AdamW
  under a warm-up over polynomial decay and a global-norm clip, fused
  (phase 10ep's program on the CPU).
- The encoder lane's MFU numerator is the one ERNIE's and GPT's share:
  6 N over the product weights plus 12·L·D·T, equal to the JAX
  package's ERNIE count at ERNIE-base's widths once its embeddings and
  MLM head are taken out.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import clip as JC
from paddle_tpu.framework import unique_name as JUN
from paddle_tpu.models import transformer_encoder as JTE
import paddle_tpu_torch as T
from paddle_tpu_torch import clip as TC
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.models import transformer_encoder as TTE
from paddle_tpu_torch.testing import adam_state_gap

from test_torch_fluid_ops import _check, _randn
from test_torch_fluid_program import _assert_same_desc


@pytest.mark.parametrize("bias", ["none", "full", "pad", "unflashable"])
def test_multihead_matmul_matches_jax(bias):
    rng = np.random.default_rng(0)
    B, S, nh, hd = 2, 6, 3, 4
    H = nh * hd
    ins = {"Input": [_randn(rng, B, S, H)], "W": [_randn(rng, H, 3 * H) * 0.3],
           "Bias": [_randn(rng, 3 * H) * 0.1]}
    shape = {"full": (B, nh, S, S), "pad": (B, 1, 1, S),
             "unflashable": (1, nh, S, S)}.get(bias)
    if shape is not None:
        b = _randn(rng, *shape)
        if bias == "pad":
            b = np.where(np.arange(S) < 4, 0.0, -1e4).astype(np.float32)
            b = np.broadcast_to(b, shape).copy()
        ins["BiasQK"] = [b]
    _check("multihead_matmul", ins, {"Out": 1},
           {"head_number": nh, "alpha": 1.0 / np.sqrt(hd)}, ["Out"],
           ["Input", "W", "Bias"])


V, S = 30, 8
LR = 2e-3


def _build(pk, un, TE, C, variant, **kw):
    with un.guard():
        main, startup = pk.Program(), pk.Program()
        main.random_seed = startup.random_seed = 11
        with pk.program_guard(main, startup):
            src = pk.layers.data("src", [S], dtype="int64")
            pos = pk.layers.data("pos", [S], dtype="int64")
            label = pk.layers.data("label", [1], dtype="int64")
            if variant == "reference":
                loss, _ = TE.transformer_encoder_classifier(
                    src, pos, label, vocab_size=V, max_pos=S, **kw)
                pk.optimizer.Adam(LR).minimize(loss)
            else:
                bias = pk.layers.data("bias", [1, 1, S], dtype="float32")
                enc = TE.encoder(src, pos, V, S, 2, 4, 32, 64, name="enc",
                                 attn_bias=bias)
                cls = pk.layers.reshape(
                    pk.layers.slice(enc, axes=[1], starts=[0], ends=[1]),
                    [-1, 32])
                logits = pk.layers.fc(pk.layers.fc(cls, 32, act="tanh"), 2)
                loss = pk.layers.reduce_mean(
                    pk.layers.softmax_with_cross_entropy(logits, label))
                lr = pk.layers.linear_lr_warmup(
                    pk.layers.polynomial_decay(LR, 10, 1e-4), 3, 0.0, LR)
                pk.optimizer.AdamW(
                    lr, weight_decay=0.01, fuse=True,
                    grad_clip=C.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("variant,kw", [
    ("reference", dict(num_layers=2, num_heads=4, d_model=32, d_ff=64)),
    ("reference", {}),                  # the function's own defaults
    ("padded_adamw", {}),
], ids=["test_widths", "defaults", "padded_adamw"])
def test_encoder_trains_like_jax(variant, kw):
    jm, js, jl = _build(fluid, JUN, JTE, JC, variant, **kw)
    tm, ts, tl = _build(T, TUN, TTE, TC, variant, **kw)
    if variant == "reference":
        _assert_same_desc(jm, tm)
    else:       # the LR counter's cast records int64 here (ROADMAP C)
        assert [o.type for o in tm.global_block().ops] == \
            [o.type for o in jm.global_block().ops]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = [n for n, v in jm.global_block().vars.items()
             if v.persistable and jscope.find_var(n) is not None]
    texe = T.Executor(T.CPUPlace())
    rng = np.random.RandomState(0)
    B = 16
    src = rng.randint(2, V, (B, S)).astype("int64")
    feed = {"src": src, "pos": np.tile(np.arange(S, dtype="int64"), (B, 1)),
            "label": (src == 5).any(1).astype("int64").reshape(B, 1)}
    if variant != "reference":
        lens = rng.randint(3, S + 1, B)
        feed["bias"] = np.where(np.arange(S)[None] < lens[:, None], 0.0,
                                -1e4).astype(np.float32)[:, None, None, :]
    losses = []
    for step in range(5):
        tscope = T.scope_from_numpy({n: np.asarray(jscope.find_var(n))
                                     for n in names}, T.CPUPlace())
        jloss = float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                          scope=jscope)[0]))
        tloss = float(texe.run(tm, feed=feed, fetch_list=[tl],
                               scope=tscope)[0])
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (step, tloss, jloss)
        losses.append(tloss)
        worst, name, floor_worst, _n = adam_state_gap(
            {n: tscope.find_var(n) for n in names},
            {n: torch.from_numpy(np.array(jscope.find_var(n)))
             for n in names}, jm, LR)
        assert worst <= 1e-5, (step, name, worst)
        assert floor_worst <= 2 * LR, (step, floor_worst)
    assert losses[-1] < losses[0]


def test_encoder_flops_are_ernies_numerator():
    from paddle_tpu.models import ernie as JE

    from paddle_tpu_torch.tools import train_bench as TB

    cfg, T_ = TB.ENCODER, 512
    D, L, d_ff = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    n_dense = L * (4 * D * D + 2 * D * d_ff)
    got = TB.encoder_flops_per_token(cfg, T_)
    assert got == 6 * n_dense + 12 * L * D * T_
    jcfg = JE.ERNIE_BASE
    assert (jcfg.d_model, jcfg.num_layers, jcfg.d_ff) == (D, L, d_ff)
    n_emb = (jcfg.vocab_size + jcfg.max_seq_len + jcfg.type_vocab_size) * D
    head = 6 * jcfg.max_masked * D * jcfg.vocab_size // T_
    assert got == JE.pretrain_flops_per_token(jcfg, n_emb + n_dense,
                                              T_) - head


def test_train_bench_fluid_lanes_rehearse_on_cpu(capsys):
    """``train_bench --model encoder|resnet50 --device cpu --tiny`` run the
    card lanes' programs on the CPU (the encoder with its traced step):
    finite losses, the schedule's learning rates, no kernel launched, no
    device metric (MFU and peak memory null). Without ``--device cpu``
    they refuse to run where there is no card."""
    import json

    import torch

    from paddle_tpu_torch.tools import train_bench as TB

    assert TB.main(["--model", "encoder", "--device", "cpu", "--tiny",
                    "--profile", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["losses"]) == 1 + TB.ENCODER_STEPS
    assert all(np.isfinite(rec["losses"]))
    np.testing.assert_allclose(rec["lrs"], rec["lrs_want"], rtol=1e-6)
    assert rec["launches_per_step"] == {} and rec["mfu"] is None
    assert rec["peak_mem_bytes"] is None
    assert rec["trace"]["source"] == "cpu_ops" and rec["trace"]["busy_ms"] > 0
    assert TB.main(["--model", "resnet50", "--device", "cpu", "--tiny"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["config"] == "resnet18_b4_32px_bf16amp_fused"
    assert rec["amp"] == "bf16" and all(np.isfinite(rec["losses"]))
    if not torch.cuda.is_available():
        for model in ("encoder", "resnet50"):
            assert TB.main(["--model", model]) == 2
