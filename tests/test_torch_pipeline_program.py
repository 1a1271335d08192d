"""``PipelineOptimizer`` in the port against ``paddle_tpu``'s, on the CPU:
a user Program trained as GPipe stages over gloo ranks
(``parallel/pipeline_program.py``), ported from the reference's
``tests/test_pipeline_optimizer.py`` and ``tests/test_parallel_compose.py``.

Each stage is one rank of a gloo world of CPU processes
(``tests/torch_dist_worker.py``; one world of two ranks and one of four
for the file); every rank runs ``Executor.run`` with the global batch.
The JAX side runs here, from its own startup, whose persistables start
the port. Bands are the reference's: losses and parameters within rtol
2e-4, atol 1e-5 of the JAX package's single-device run (5e-4 at four
stages), for

- the even split (also with each stage under the "full" remat policy),
  the cut list, four stages, an int32 var crossing the
  cut (it carries no gradient back), pp2 x dp2 (``with_data_parallel``
  on a pipeline program), the small encoder under ``AdamW(grad_clip=
  GradientClipByGlobalNorm(1.0))`` (its parameters against the port's
  own single-device run and JAX's by ``testing.adam_state_gap``, the
  encoder tests' measure: within 2e-4 of each tensor's scale, Adam's
  noise-floor elements within lr a step);
- batch norm's statistics threaded through the microbatches in order,
  held to the JAX package's own pipeline run (rtol 5e-4, atol 1e-5);
- a batch M does not divide (the reference's ``ValueError``), and the
  two configurations the reference cannot run, refused by name: AMP
  under the pipeline (either order) and an LR schedule.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.testing import adam_state_gap, mesh_feed, mesh_program

import torch_dist_worker as W

STEPS = 3
PP_TOL = dict(rtol=2e-4, atol=1e-5)

# name -> (world size, mesh_program kwargs of the pipeline program, how
# the ranks run it, the kwargs of the JAX oracle's program, its run)
CASES = {
    "even": (2, dict(net="mlp", wrap="pipeline"), "plain",
             dict(net="mlp"), "single"),
    "remat_full": (2, dict(net="mlp", wrap="pipeline", remat="full"),
                   "plain", dict(net="mlp"), "single"),
    "cut_list": (2, dict(net="mlp", wrap="pipeline", cut=True,
                         microbatches=4), "plain", dict(net="mlp"),
                 "single"),
    "int_cut": (2, dict(net="int_cut", wrap="pipeline", cut=True),
                "plain", dict(net="int_cut"), "single"),
    "bn_stats": (2, dict(net="bn_mlp", wrap="pipeline"), "plain",
                 dict(net="bn_mlp", wrap="pipeline"), "pipeline"),
    "encoder": (2, dict(net="encoder", opt="adamw_clip", lr=0.01,
                        wrap="pipeline", microbatches=4), "plain",
                dict(net="encoder", opt="adamw_clip", lr=0.01), "single"),
    "four_stages": (4, dict(net="mlp", wrap="pipeline", stages=4,
                            microbatches=4), "plain", dict(net="mlp"),
                    "single"),
    "pp2_dp2": (4, dict(net="mlp", wrap="pipeline"), "dp",
                dict(net="mlp"), "single"),
}


def _jax(kw, feed, how, start=None, steps=STEPS):
    """(the start state, each step's loss, the persistables after) of the
    JAX package's ``mesh_program(**kw)``."""
    main, startup, loss = mesh_program(fluid, JUN, **kw)
    exe, scope = fluid.Executor(fluid.XLAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    names = [n for n, v in main.global_block().vars.items()
             if v.persistable and scope.find_var(n) is not None]
    for n in names:
        if start is not None and n in start:
            scope.set_var(n, jnp.asarray(start[n]))
    first = {n: np.array(scope.find_var(n)) for n in names}
    losses = [float(np.mean(np.asarray(exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope)[0])))
        for _ in range(steps)]
    return first, losses, {n: np.array(scope.find_var(n)) for n in names}


def _port_single(kw, feed, start, steps=STEPS):
    main, _startup, loss = mesh_program(T, TUN, **kw)
    exe, scope = T.Executor(T.CPUPlace()), T.scope_from_numpy(start,
                                                               T.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, {n: scope.find_var(n).numpy() for n in start}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name -> (the JAX losses, the JAX persistables, the ranks'
    results): the pipelined program's start state is its own JAX
    startup's, which the oracle program (the same net without the
    pipeline) starts from too."""
    jobs = {2: [], 4: []}
    oracle = {}
    for name, (world, kw, how, jkw, jhow) in CASES.items():
        feed = mesh_feed(kw["net"], 16)
        start, _, _ = _jax(kw, feed, "single", steps=0)
        _, losses, state = _jax(jkw, feed, jhow, start)
        oracle[name] = (losses, state)
        oracle[name + "/start"] = start
        jobs[world].append((name, ("fluid_mesh_worker",
                                   (kw, start, feed, STEPS, how))))
    feed = mesh_feed("mlp", 16)
    bad = dict(net="mlp", wrap="pipeline", microbatches=3)
    start, _, _ = _jax(bad, feed, "single", steps=0)
    jobs[2].append(("indivisible", ("mesh_error_worker",
                                    (bad, start, feed))))
    out = {}
    for world, js in jobs.items():
        ranks = W.spawn(W.jobs_worker, world, [j[1] for j in js],
                        out_dir=str(tmp_path_factory.mktemp(f"pp{world}")),
                        timeout=150)
        for i, (name, _) in enumerate(js):
            out[name] = (oracle.get(name), [r[i] for r in ranks])
    out.update({k: v for k, v in oracle.items() if k.endswith("/start")})
    return out


@pytest.mark.parametrize("name", ["even", "remat_full", "cut_list",
                                  "int_cut", "encoder", "four_stages",
                                  "pp2_dp2"])
def test_pipeline_matches_single_device(worlds, name):
    """Every rank fetches the same loss (at least 1-d) and leaves the same
    parameters, within the reference's band of the JAX package's
    single-device run."""
    (losses, state), ranks = worlds[name]
    tol = dict(rtol=5e-4, atol=1e-5) if name == "four_stages" else PP_TOL
    params = [n for n in state if n.startswith(("w", "b", "enc_"))
              and not n.endswith(("_moment1_0", "_moment2_0"))]
    assert params
    adam = CASES[name][1].get("opt") == "adamw_clip"
    if adam:
        # the port's own single-device run: the pipeline's band holds
        # element by element against it
        own_l, own_s = _port_single(CASES[name][3], mesh_feed("encoder", 16),
                                    worlds[name + "/start"])
    for rank in ranks:
        got = [float(np.mean(r[0])) for r in rank["runs"]]
        assert all(r[0].shape == (1,) for r in rank["runs"])
        np.testing.assert_allclose(got, losses, **tol)
        if not adam:
            for n in params:
                np.testing.assert_allclose(rank["state"][n], state[n],
                                           err_msg=n, **tol)
            continue
        np.testing.assert_allclose(got, own_l, **tol)
        # Adam divides each gradient element by its own root mean square,
        # so where a gradient is zero but for rounding (the k bias, to
        # which attention is invariant) the step follows the rounding (the
        # microbatches sum in another order), up to lr a step; the rest
        # within rtol 2e-4 of each tensor's scale, against the port's own
        # single-device run and JAX's
        prog = mesh_program(T, TUN, **CASES[name][3])[0]
        for want in (own_s, state):
            worst, n, floor_worst, _ = adam_state_gap(
                {n: torch.from_numpy(rank["state"][n]) for n in want},
                {n: torch.from_numpy(np.asarray(want[n])) for n in want},
                prog, 0.01)
            assert worst <= tol["rtol"], (n, worst)
            assert floor_worst <= 0.01 * STEPS, floor_worst


def test_pipeline_threads_bn_stats_through_microbatches(worlds):
    """Batch norm's moving statistics update once a microbatch, in order,
    on the stage that owns them, and reach every rank: as the JAX
    package's own pipeline run leaves them."""
    (losses, state), ranks = worlds["bn_stats"]
    assert not np.allclose(state["bn_mean"], 0.0)
    for rank in ranks:
        got = [float(np.mean(r[0])) for r in rank["runs"]]
        np.testing.assert_allclose(got, losses, rtol=5e-4, atol=1e-5)
        for n in ("bn_mean", "bn_variance", "w1", "w3"):
            np.testing.assert_allclose(rank["state"][n], state[n],
                                       rtol=5e-4, atol=1e-5, err_msg=n)


def test_pipeline_rejects_indivisible_batch(worlds):
    _, ranks = worlds["indivisible"]
    for err in ranks:
        assert err[0] == "ValueError" and "divisible" in err[1], err
        assert "num_microbatches 3" in err[1]


def test_pipeline_annotation_and_cut_errors():
    """The stage split the reference records, and its error for a cut at
    a var no forward op makes."""
    main, _, _ = mesh_program(T, TUN, net="mlp", wrap="pipeline")
    jm, _, _ = mesh_program(fluid, JUN, net="mlp", wrap="pipeline")
    ann, jann = main._annotations["pipeline"], jm._annotations["pipeline"]
    for k in ("stage_ranges", "n_fwd", "bwd_end", "loss", "microbatches",
              "remat"):
        assert list(ann[k]) == list(jann[k]) if k == "stage_ranges" \
            else ann[k] == jann[k], k
    assert sorted(ann["trainable"]) == sorted(jann["trainable"])
    with TUN.guard():
        prog, startup = T.Program(), T.Program()
        with T.program_guard(prog, startup):
            x = T.layers.data("x", [8], dtype="float32")
            loss = T.layers.mean(T.layers.fc(x, 1))
            with pytest.raises(ValueError, match="must be produced"):
                T.optimizer.PipelineOptimizer(
                    T.optimizer.SGD(0.1), cut_list=[[x]]).minimize(loss)


def test_pipeline_refuses_amp_and_lr_schedule():
    """AMP under the pipeline (either order) and a ``learning_rate``
    Variable raise ``NotImplementedError`` naming the configuration and
    the reference's ``KeyError``."""
    from paddle_tpu_torch.contrib import mixed_precision as MP

    with TUN.guard():
        main, startup = T.Program(), T.Program()
        with T.program_guard(main, startup):
            with pytest.raises(NotImplementedError,
                               match="AMP with PipelineOptimizer.*KeyError"):
                T.optimizer.PipelineOptimizer(
                    MP.decorate(T.optimizer.SGD(0.1), use_bf16=True))
            with pytest.raises(NotImplementedError,
                               match="AMP with PipelineOptimizer"):
                MP.decorate(T.optimizer.PipelineOptimizer(
                    T.optimizer.SGD(0.1)), use_bf16=True)
            lr = T.layers.polynomial_decay(0.1, 100)
            with pytest.raises(NotImplementedError,
                               match="LR schedule.*KeyError: 'LearningRate'"):
                T.optimizer.PipelineOptimizer(T.optimizer.AdamW(lr))
