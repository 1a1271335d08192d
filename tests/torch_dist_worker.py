"""Spawned ranks for the port's multi-rank tests.

Each world is ``torch.multiprocessing`` processes joined over gloo on the
CPU; a rank imports only torch and ``paddle_tpu_torch`` (never jax), runs
one of the ``*_worker`` functions below and saves what it returns (numpy
arrays and floats) for the parent test, which holds it against the JAX
package. The rendezvous and every collective time out after
``GLOO_TIMEOUT_S`` and the parent stops waiting after ``timeout`` seconds
(killing the ranks), so a hang fails one test.
"""
import os
import time
import traceback

import torch
import torch.multiprocessing as mp

GLOO_TIMEOUT_S = 60
DEVICE = "cpu"          # this rank's device, set by _entry


def _entry(rank, fn, world, out_dir, device):
    global DEVICE
    DEVICE = device
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "LOCAL_RANK": str(rank)})
    torch.set_num_threads(1)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import env

    # a file store: no TCP rendezvous (whose server looks up every
    # client's host name, one at a time)
    env.init_distributed_env(
        backend="gloo", device=device, timeout_s=GLOO_TIMEOUT_S,
        init_method="file://" + os.path.join(out_dir, "store"))
    try:
        args = torch.load(os.path.join(out_dir, "args.pt"),
                          weights_only=False)
        res = fn(rank, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, out_dir: str, timeout: float = 120.0,
          device: str = "cpu"):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks, each on ``device``
    (all on one card when it names one); returns the list of their
    results in rank order. Raises on a failed rank (with its traceback)
    or when the world has not ended within ``timeout``."""
    os.makedirs(out_dir, exist_ok=True)
    # the arguments go by file: pickling arrays into the spawn call costs
    # seconds a rank
    torch.save(args, os.path.join(out_dir, "args.pt"))
    ctx = mp.start_processes(_entry, args=(fn, world, out_dir, device),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world of {world} did not end within "
                                   f"{timeout} s")
    except Exception as e:
        errs = [open(os.path.join(out_dir, f)).read()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        raise RuntimeError(f"{e}\n" + "\n".join(errs)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' work
# ---------------------------------------------------------------------------

def _setup(cfg_kw, pcfg_kw):
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg = G.GPT_TINY.scaled(**cfg_kw)
    pcfg = PZ.ParallelConfig(**pcfg_kw)
    return cfg, pcfg, PZ.build_mesh(pcfg, device=DEVICE)


def _numpy(leaves):
    return [t.detach().float().cpu().numpy().copy() for t in leaves]


def grads_worker(rank, cfg_kw, pcfg_kw, params_np, tokens, labels,
                 variants=((False, ()),)):
    """The summed loss and this rank's grad shards after the spec rule
    (and before it, ``raw``), once per variant ``(double_buffer, config
    overrides as key-value pairs)``, keyed by the variant."""
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg, pcfg, mesh = _setup(cfg_kw, pcfg_kw)
    specs = PZ.flat_specs(cfg, pcfg)
    params = PZ.shard_params(params_np, PZ._unflatten(params_np, specs),
                             mesh)
    toks = PZ._rank_batch(tokens, pcfg, mesh, cfg)
    labs = PZ._rank_batch(labels, pcfg, mesh, cfg)
    out = {"coords": mesh.coords}
    for db, over in variants:
        loss, grads = PZ._value_and_grad(params, toks, labs,
                                         cfg.scaled(**dict(over)), pcfg,
                                         mesh, db)
        raw = _numpy(grads)
        with torch.no_grad():
            loss = PZ._psum_loss(loss, mesh)
            grads = PZ.psum_grads_by_spec(grads, specs, mesh)
        out[(db, over)] = {"loss": float(loss), "grads": _numpy(grads),
                           "raw": raw}
    return out


def step_worker(rank, cfg_kw, pcfg_kw, params_np, tokens, labels, runs):
    """For each run ``{"step_kw": ..., "steps": n, "nan_step": k}`` in
    turn: ``n`` train steps of ``make_train_step(**step_kw)`` from the
    given params (``init_sharded`` with the same comm kwargs lays out the
    optimizer state). Returns, a run each, the losses, grad norms, this
    rank's param shards, the optimizer state and the wire bytes counted.
    ``nan_step`` poisons the embedding with NaN for that step (and
    restores it after), recording whether the step kept params and
    optimizer state (``kept``)."""
    cfg, pcfg, mesh = _setup(cfg_kw, pcfg_kw)
    return [_train(cfg, pcfg, mesh, params_np, tokens, labels,
                   run["step_kw"], run.get("steps", 3), run.get("nan_step"))
            for run in runs]


def _train(cfg, pcfg, mesh, params_np, tokens, labels, step_kw, steps,
           nan_step):
    from paddle_tpu_torch.observability import metrics as M
    from paddle_tpu_torch.parallel import parallelize as PZ

    init_kw = {k: v for k, v in step_kw.items()
               if k in ("grad_reduce", "bucket_mb", "error_feedback",
                        "grad_allreduce_dtype", "fused_opt", "moment_dtype")}
    step_kw = {k: v for k, v in step_kw.items() if k != "moment_dtype"}
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, device=DEVICE, **init_kw)
    src = PZ.shard_params(params_np, PZ._unflatten(
        params_np, PZ.flat_specs(cfg, pcfg)), mesh)
    for dst, s in zip(PZ.flat_leaves(params), PZ.flat_leaves(src)):
        dst.copy_(s)
    step = PZ.make_train_step(cfg, pcfg, mesh, **step_kw)

    def wire():
        fam = M.default_registry().snapshot().get(
            "paddle_collective_bytes_total", {"series": []})
        return {tuple(s["labels"]): s["value"] for s in fam["series"]}

    before = wire()
    losses, gnorms, kept = [], [], []
    for i in range(steps):
        if i == nan_step:
            clean = params["wte"].clone()
            params["wte"].mul_(float("nan"))
            saved = [t.clone() for t in PZ.flat_leaves(params)]
            saved_opt = {k: v.clone() for k, v in opt.items()
                         if isinstance(v, torch.Tensor)}
        params, opt, loss, gnorm = step(params, opt, tokens, labels)
        if i == nan_step:
            kept.append(all(torch.equal(a.nan_to_num(), b.nan_to_num())
                            for a, b in zip(PZ.flat_leaves(params), saved)))
            kept.append(all(torch.equal(opt[k], v)
                            for k, v in saved_opt.items()))
            params["wte"].copy_(clean)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    after = wire()
    return {"coords": mesh.coords, "losses": losses, "gnorms": gnorms,
            "params": _numpy(PZ.flat_leaves(params)),
            "opt": {k: v.float().cpu().numpy() if v.dim() else float(v)
                    for k, v in opt.items() if isinstance(v, torch.Tensor)},
            "kept": kept,
            "wire": {k: after[k] - before.get(k, 0) for k in after}}


def collective_worker(rank, xs, chunk):
    """The quantized all-reduce (bf16 and int8) and the float32 sum of
    ``xs[rank]`` over a dp line of the whole world; the mesh's
    ``axis_index`` / ``axis_size`` under ``mesh_guard``."""
    from paddle_tpu_torch.parallel import comm_opt, mesh as mesh_mod

    mesh = mesh_mod.build_mesh([("dp", len(xs))], device="cpu")
    with mesh_mod.mesh_guard(mesh):
        guard = (mesh_mod.current_mesh() is mesh, mesh_mod.axis_index("dp"),
                 mesh_mod.axis_size("dp"))
    g = mesh.group("dp")
    x = torch.from_numpy(xs[rank])
    exact = g.all_reduce(x.clone())
    bf16 = comm_opt.quantized_allreduce(x, g, "bf16")
    i8 = comm_opt.quantized_allreduce(x, g, "int8", quant_chunk=chunk)
    rs = comm_opt.quantized_reduce_scatter_op(x.reshape(len(xs), -1), g,
                                              "int8", quant_chunk=chunk)
    return {"exact": exact.numpy(), "bf16": bf16.numpy(), "int8": i8.numpy(),
            "rs": rs.numpy(), "guard": guard,
            "unguarded": mesh_mod.current_mesh() is None}


def device_worker(rank, cfg_kw):
    """Where a dp-2 mesh and its entry points put this rank: ``build_mesh``
    without a device (its device, or the error's name), the entry points
    given another device than the mesh's, and their devices without one."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg, pcfg = G.GPT_TINY.scaled(**cfg_kw), PZ.ParallelConfig(dp=2)
    out = {"card": torch.cuda.is_available()}
    try:
        out["default"] = str(PZ.build_mesh(pcfg).device)
    except RuntimeError as e:
        out["default"] = type(e).__name__
    mesh = PZ.build_mesh(pcfg, device="cpu")
    out["named"] = {}
    for name, fn in (("init_sharded", PZ.init_sharded),
                     ("make_train_step", PZ.make_train_step)):
        try:
            fn(cfg, pcfg, mesh, device="cuda:0")
            out["named"][name] = "ran"
        except (RuntimeError, ValueError):
            out["named"][name] = "raised"
    params, opt = PZ.init_sharded(cfg, pcfg, mesh)
    out["follows"] = [str(params["wte"].device), str(opt["step"].device)]
    PZ.make_train_step(cfg, pcfg, mesh)
    return out


def forward_worker(rank, cfg_kw, pcfg_kw, params_np, tokens):
    """``make_forward``'s logits on this rank."""
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg, pcfg, mesh = _setup(cfg_kw, pcfg_kw)
    params = PZ.shard_params(params_np, PZ._unflatten(
        params_np, PZ.flat_specs(cfg, pcfg)), mesh)
    return {"logits": PZ.make_forward(cfg, pcfg, mesh)(params, tokens
                                                        ).numpy()}


def jobs_worker(rank, jobs):
    """Each ``(worker name, args)`` of ``jobs`` in turn over the same world
    (each builds its own mesh, whose rank count is the world's); their
    results in order. One spawn for many cases."""
    return [globals()[name](rank, *args) for name, args in jobs]


def ring_worker(rank, q, k, v, w, cases, mesh_axes=None):
    """``ring_attention`` on this rank's sequence chunk of the global q, k,
    v [B, T, nh, hd] (on this rank's device): for each ``(causal, grads)``
    case the output chunk and, with ``grads``, the chunks' gradients of
    sum(out · w). With ``mesh_axes`` (pairs ending in ("cp", n)) the ring
    is the cp line of that mesh and the chunk is this rank's cp index."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    group, idx = None, rank
    if mesh_axes is not None:
        mesh = mesh_mod.build_mesh(mesh_axes, device=DEVICE)
        group, idx = mesh.group("cp"), mesh.axis_index("cp")
        cp = mesh.axis_size("cp")
    else:
        cp = torch.distributed.get_world_size()
    tl = q.shape[1] // cp
    sl = slice(idx * tl, (idx + 1) * tl)

    def chunk(a):
        return torch.from_numpy(a[:, sl].copy()).to(DEVICE)

    out = {"index": idx}
    for causal, grads in cases:
        qs, ks, vs = [chunk(a).requires_grad_(grads) for a in (q, k, v)]
        o = ring_attention(qs, ks, vs, group, causal=causal)
        rec = {"o": o.detach().cpu().numpy()}
        if grads:
            (o * chunk(w)).sum().backward()
            rec["grads"] = [t.grad.cpu().numpy() for t in (qs, ks, vs)]
        out[(causal, grads)] = rec
    return out


def elastic_cross_worker(rank, cfg_kw, dp, jax_dir, port_dir, tokens,
                         labels, moment_dtype):
    """Restore a checkpoint the JAX package wrote (``jax_dir``) into this
    rank's reduce-scatter train state, save it again with the port's gang
    store (``port_dir``, step 3), then take one step: the loss before the
    update, the live layout's manifest entry, and the restored opt step."""
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg, pcfg, mesh = _setup(cfg_kw, dict(dp=dp))
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=5,
                                  moment_dtype=moment_dtype,
                                  grad_reduce="reduce_scatter")
    layout, repl = PZ.rs_param_layout(cfg, pcfg)
    specs = C.train_state_specs(cfg, pcfg, opt)
    ck = C.ElasticCheckpointer(jax_dir, mesh=mesh)
    params, opt, man = C.restore_train_state(
        ck, params, opt, layout=layout, layout_repl=repl, mesh=mesh,
        specs=specs)
    mine = C.ElasticCheckpointer(port_dir, mesh=mesh)
    mine.save(3, {"params": params, "opt": opt}, layout=layout,
              layout_repl=repl, specs=specs)
    mine.wait()
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=1e-2,
                              grad_reduce="reduce_scatter")
    _, _, loss, _ = step(params, opt, tokens, labels)
    return {"loss": float(loss), "step": int(opt["step"]),
            "layout": C.serialize_layout(layout, repl),
            "manifest_layout": man["layout"]}


def elastic_reshard_worker(rank, cfg_kw, dp, ckpt_dir, tokens, labels,
                           save):
    """``save``: dp ranks take one reduce-scatter step and save (bf16
    moments) to ``ckpt_dir``; else restore that save at this world's dp
    and return the moments resharded back into the saved layout, with the
    params' bytes."""
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg, pcfg, mesh = _setup(cfg_kw, dict(dp=dp))
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=1 if save else 9,
                                  moment_dtype=torch.bfloat16,
                                  grad_reduce="reduce_scatter")
    layout, repl = PZ.rs_param_layout(cfg, pcfg)
    specs = C.train_state_specs(cfg, pcfg, opt)
    ck = C.ElasticCheckpointer(ckpt_dir, mesh=mesh)
    if save:
        step = PZ.make_train_step(cfg, pcfg, mesh, lr=1e-2,
                                  grad_reduce="reduce_scatter")
        step(params, opt, tokens, labels)
        ck.save(1, {"params": params, "opt": opt}, layout=layout,
                layout_repl=repl, specs=specs)
        ck.wait()
        return {"layout": C.serialize_layout(layout, repl)}
    params, opt, man = C.restore_train_state(
        ck, params, opt, layout=layout, layout_repl=repl, mesh=mesh,
        specs=specs)
    src, src_repl = C.deserialize_layout(man["layout"])
    back = {k: C.reshard_flat(opt[k], layout, src, repl, src_repl)
            .view(torch.int16).numpy() for k in ("m", "v")}
    return {"back": back, "step": int(opt["step"]),
            "params": _numpy(PZ.flat_leaves(params))}


def sharded_worker(rank, cfg_kw, pcfg_kw, params_np, tokens, labels, modes,
                   steps=3, lr=1e-2):
    """For each sharding plan of ``modes`` in turn: ``init_sharded`` and
    ``make_train_step`` with ``sharding=`` that plan, the params replaced
    by this rank's shards of ``params_np``, ``steps`` steps. Returns, a
    plan each, the losses, grad norms, this rank's param and moment
    shards, their bytes, the step's report name and the wire bytes
    counted."""
    from paddle_tpu_torch.observability import metrics as M
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.sharding import resolve_plan

    cfg, pcfg, mesh = _setup(cfg_kw, pcfg_kw)

    def wire():
        fam = M.default_registry().snapshot().get(
            "paddle_collective_bytes_total", {"series": []})
        return {"/".join(s["labels"]): s["value"] for s in fam["series"]}

    out = {"coords": mesh.coords}
    for mode in modes:
        plan = resolve_plan(mode, cfg, pcfg)
        params, opt = PZ.init_sharded(cfg, pcfg, mesh, sharding=plan)
        for dst, src in zip(PZ.flat_leaves(params), PZ.flat_leaves(
                PZ.shard_params(params_np, plan.param_specs, mesh))):
            dst.copy_(src)
        step = PZ.make_train_step(cfg, pcfg, mesh, lr=lr, sharding=plan)
        before = wire()
        losses, gnorms = [], []
        for _ in range(steps):
            params, opt, loss, gnorm = step(params, opt, tokens, labels)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        after = wire()
        out[str(mode)] = {
            "losses": losses, "gnorms": gnorms,
            "params": _numpy(PZ.flat_leaves(params)),
            "m": _numpy(PZ.flat_leaves(opt["m"])),
            "v": _numpy(PZ.flat_leaves(opt["v"])),
            "param_bytes": PZ.resident_bytes(params),
            "moment_bytes": PZ.resident_bytes(opt["m"])
            + PZ.resident_bytes(opt["v"]),
            "report_name": step.report_name,
            "wire": {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}}
    return out


def ckpt_state(params, specs_like, scale=0.1):
    """A train state made from full numpy params: the params, bf16 ``m``
    (``scale`` x p) and float32 ``v`` (p²), an int32 step; each moment
    equal on every rank that holds the same shard."""
    def moment(tree, fn, dt):
        return {k: moment(v, fn, dt) if isinstance(v, dict)
                else fn(v).to(dt) for k, v in tree.items()}

    return {"params": params,
            "opt": {"m": moment(params, lambda p: p * scale, torch.bfloat16),
                    "v": moment(params, lambda p: p * p, torch.float32),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _host_leaves(tree):
    """[(keystr, numpy)] with bf16 leaves as their raw int16 words."""
    from paddle_tpu_torch.parallel.checkpoint import flatten_with_keys

    return [(k, (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
             .cpu().numpy().copy()) for k, t in flatten_with_keys(tree)]


def sharded_ckpt_worker(rank, cfg_kw, params_np, ckpt_dir):
    """On a (dp 2, tp 2) mesh: save a Megatron-split state (async, then
    ``wait``) and an fsdp-plan state; restore the first at the same
    layout (bitwise per rank), at (dp 4, tp 1) and at (dp 1, tp 4) (each
    rank's local leaves returned with its coordinates); a save by a
    checkpointer without a mesh is refused."""
    import os

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.sharding import make_gpt_plan

    cfg = G.GPT_TINY.scaled(**cfg_kw)
    mesh = mesh_mod.build_mesh([("dp", 2), ("pp", 1), ("tp", 2)],
                               device=DEVICE)
    specs = G.param_specs(cfg, pp="pp", tp="tp")
    sspecs = {"params": specs, "opt": {"m": specs, "v": specs}}
    state = ckpt_state(PZ.shard_params(params_np, specs, mesh), specs)
    ck = C.ShardedCheckpointer(os.path.join(ckpt_dir, "megatron"),
                               use_async=True, mesh=mesh)
    ck.save(3, state, specs=sspecs)
    ck.wait()
    abstract = C.abstract_like(state, sspecs, mesh)
    same = ck.restore(3, abstract)
    out = {"same": all(torch.equal(a, b) for (_, a), (_, b) in zip(
        C.flatten_with_keys(state), C.flatten_with_keys(same))),
        "latest": ck.latest_step()}
    for name, axes in (("dp4", [("dp", 4), ("pp", 1), ("tp", 1)]),
                       ("tp4", [("dp", 1), ("pp", 1), ("tp", 4)])):
        m2 = mesh_mod.build_mesh(axes, device=DEVICE)
        got = ck.restore(3, C.abstract_for_mesh(abstract, sspecs, m2))
        out[name] = {"coords": m2.coords, "leaves": _host_leaves(got)}
    plan = make_gpt_plan(cfg, PZ.ParallelConfig(dp=2, tp=2), "fsdp")
    fspecs = {"params": plan.param_specs,
              "opt": {"m": plan.param_specs, "v": plan.param_specs}}
    fstate = ckpt_state(PZ.shard_params(params_np, plan.param_specs, mesh),
                        plan.param_specs)
    fck = C.ShardedCheckpointer(os.path.join(ckpt_dir, "fsdp"),
                                use_async=False, mesh=mesh)
    fck.save(1, fstate, specs=fspecs)
    out["fsdp_local_bytes"] = PZ.resident_bytes(fstate["params"])
    # without a mesh every rank would write the same files: refused on
    # every rank alike, before any file or collective
    lone = C.ShardedCheckpointer(os.path.join(ckpt_dir, "no_mesh"),
                                 use_async=False)
    try:
        lone.save(1, fstate)
        out["no_mesh"] = None
    except C.CheckpointError as e:
        out["no_mesh"] = str(e)
    out["no_mesh_steps"] = lone.all_steps()
    return out


def ernie_mesh_worker(rank, axes, params_np, batch, arms, steps, lr):
    """For each arm (ERNIE_TINY config overrides) in turn: ``steps``
    momentum steps of ``make_pretrain_step(mesh=)`` on a mesh of ``axes``
    from this rank's shards of ``params_np``, on the GLOBAL ``batch``.
    Returns, an arm each, the losses and this rank's param shards."""
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import parallelize as PZ

    mesh = mesh_mod.build_mesh(axes, device=DEVICE)
    out = {"coords": mesh.coords}
    for name, kw in arms.items():
        cfg = E.ERNIE_TINY.scaled(**kw)
        params = PZ.shard_params(params_np, E.param_specs(cfg), mesh)
        opt = E.init_opt(params)
        step = E.make_pretrain_step(cfg, mesh=mesh, lr=lr)
        losses = [float(step(params, opt, batch)[2]) for _ in range(steps)]
        out[name] = {"losses": losses,
                     "params": _numpy(PZ.flat_leaves(params))}
    return out


def overlap_worker(rank, cfg_kw, trace_dir):
    """One warm-up and one traced dp-2 train step of a tiny GPT (the
    grads' psum staged through gloo); returns this rank's
    ``comm_opt.measure_overlap_fraction`` of the capture."""
    import numpy as np

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import comm_opt
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.utils import device_trace as DT

    cfg = G.GPT_TINY.scaled(**cfg_kw)
    pcfg = PZ.ParallelConfig(dp=2)
    mesh = PZ.build_mesh(pcfg, device=DEVICE)
    params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=0, device=DEVICE)
    step = PZ.make_train_step(cfg, pcfg, mesh, lr=1e-3, device=DEVICE)
    tokens = torch.from_numpy(np.arange(64).reshape(1, 4, 16) % 256)
    step(params, opt, tokens, tokens)
    tdir = os.path.join(trace_dir, f"rank{rank}")
    with DT.capture(tdir, device=DEVICE):
        float(step(params, opt, tokens, tokens)[2])
    return comm_opt.measure_overlap_fraction(tdir)


# ---------------------------------------------------------------------------
# the fluid mesh: with_data_parallel, per-rank programs, the pipeline
# ---------------------------------------------------------------------------

def _numpy_state(scope, names):
    out = {}
    for n in names:
        t = scope.find_var(n)
        if t is not None:
            out[n] = t.detach().float().cpu().numpy().copy() \
                if t.is_floating_point() else t.cpu().numpy().copy()
    return out


def fluid_mesh_worker(rank, build_kw, start, feed, steps, how="plain",
                      fetch=()):
    """``steps`` runs on this rank of ``testing.mesh_program(**build_kw)``
    from the persistables ``start`` (numpy, by name), fed the global
    ``feed`` each time: ``how`` "plain" (the program itself: a pipeline
    program's stages over the world), "dp" (``CompiledProgram(main)
    .with_data_parallel(loss_name=)``), "dp_sync" (the same with
    ``BuildStrategy(sync_batch_norm=True)``). Returns each run's fetches
    (the loss first, then ``fetch``) and every persistable after."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.framework import unique_name as TUN
    from paddle_tpu_torch.testing import mesh_program

    main, _startup, loss = mesh_program(T, TUN, **build_kw)
    place = T.CPUPlace() if DEVICE == "cpu" else T.CUDAPlace(0)
    scope = T.scope_from_numpy(start, place)
    exe = T.Executor(place)
    target = main
    if how in ("dp", "dp_sync"):
        bs = T.BuildStrategy()
        bs.sync_batch_norm = how == "dp_sync"
        target = T.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
    runs = [exe.run(target, feed=feed, fetch_list=[loss.name, *fetch],
                    scope=scope) for _ in range(steps)]
    names = [n for n, v in main.global_block().vars.items() if v.persistable]
    return {"runs": runs, "state": _numpy_state(scope, names)}


def mesh_error_worker(rank, build_kw, start, feed, how="plain"):
    """The error one run raises on this rank (type name and message), or
    None."""
    try:
        fluid_mesh_worker(rank, build_kw, start, feed, 1, how)
    except Exception as e:           # the test reads which one
        return (type(e).__name__, str(e))
    return None


def collective_ops_worker(rank, x, w, lr):
    """The c_* ops of one per-rank program over the world (its fetches, a
    program run under ``with_data_parallel``; the same program routed by
    its ``_annotations["mesh"]`` instead), and one SGD step of
    ``mean(c_allreduce_sum(x @ w))`` (the gradient through the
    all-reduce; the persistables rank 0's)."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.framework import unique_name as TUN
    from paddle_tpu_torch.framework.layer_helper import LayerHelper
    from paddle_tpu_torch.layers import collective as C

    world = torch.distributed.get_world_size()
    with TUN.guard():
        main, startup = T.Program(), T.Program()
        with T.program_guard(main, startup):
            xv = T.layers.data("x", [x.shape[1]], dtype="float32")
            outs = {k: C._c_allreduce(xv, reduce_type=k)
                    for k in ("sum", "max", "min", "prod", "avg")}
            outs["allgather"] = C._c_allgather(xv, world)
            outs["reducescatter"] = C._c_reducescatter(xv, world)
            outs["broadcast"] = C._c_broadcast(xv, root=1)
            for t, attrs in (("c_concat", {}), ("c_split", {}),
                             ("c_identity", {}), ("allreduce",
                                                  {"reduce_type": 1}),
                             ("broadcast", {"root": 1})):
                helper = LayerHelper(t)
                out = helper.create_variable_for_type_inference("float32")
                helper.append_op(type=t, inputs={"X": [xv]},
                                 outputs={"Out": [out]},
                                 attrs=dict(attrs, ring_id=0))
                outs["legacy_" + t if t in ("allreduce", "broadcast")
                     else t] = out
    exe = T.Executor(T.CPUPlace())
    prog = T.CompiledProgram(main).with_data_parallel()
    got = exe.run(prog, feed={"x": x}, fetch_list=list(outs.values()),
                  scope=T.Scope())
    res = {"fetch": dict(zip(outs, got))}
    main._annotations["mesh"] = {"mode": "shard_map", "axes": [("dp", -1)],
                                 "data_axis": "dp", "ring_axes": {0: "dp"}}
    got = exe.run(main, feed={"x": x}, fetch_list=list(outs.values()),
                  scope=T.Scope())
    res["annotated"] = dict(zip(outs, got))
    with TUN.guard():
        main, startup = T.Program(), T.Program()
        with T.program_guard(main, startup):
            xv = T.layers.data("x", [x.shape[1]], dtype="float32")
            pred = T.layers.fc(xv, 1, param_attr=T.ParamAttr("w"),
                               bias_attr=False)
            loss = T.layers.mean(C._c_allreduce(pred, reduce_type="sum"))
            T.optimizer.SGD(lr).minimize(loss)
    scope = T.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("w", torch.from_numpy(w.copy()))
    prog = T.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    res["loss"] = exe.run(prog, feed={"x": x}, fetch_list=[loss],
                          scope=scope)[0]
    res["w"] = scope.find_var("w").numpy()
    return res


def fluid_gate_worker(rank, gate, tiny=False):
    """One of chip_smoke's 11f gates on this rank
    (``train_bench.encoder_pipeline_parity`` "pp2",
    ``resnet_dp_parity`` "dp2", ``collective_parity``
    "c_allreduce_sum"), on the world's device."""
    import argparse

    from paddle_tpu_torch.tools import train_bench as TB

    dev = torch.device(DEVICE)
    world = torch.distributed.get_world_size()
    args = argparse.Namespace(tiny=tiny, pp=world)
    if gate == "pp2":
        return TB.encoder_pipeline_parity(args, dev)
    if gate == "dp2":
        return TB.resnet_dp_parity(args, dev, world)
    return TB.collective_parity(dev, world, rank)
