"""Fault-injection harness for the port's elastic and in-run-health layers
— the port of ``tools/fault_bench.py``.

Workers are killed mid-step (SIGKILL), preempted (SIGTERM on the
launcher), stalled until their watchdog fires, fed a poisoned batch or
driven to diverge; a checkpoint shard is truncated and an uncommitted
step planted; a dp-2 save is restored at dp 1. Each job recovers with no
one's help, through ``parallel.launch``'s supervised restarts,
``parallel.health``'s watchdog and guardrails and
``parallel.checkpoint``'s committed steps, to final params bit-exact with
an uninterrupted run at equal dp (the batch of step s is a function of s
alone, made by numpy from a seed, so a replay after a restore is exact).

    python -m paddle_tpu_torch.tools.fault_bench [--out PATH]
    python -m paddle_tpu_torch.tools.fault_bench --smoke --device cpu \
        [--out PATH]

Scenarios:

  baseline          an uninterrupted run: the reference loss and params crc
  aa                a second baseline, bitwise: the step's own
                    determinism, on which every bit-exact resume rests
  sigkill_midstep   a worker SIGKILLs itself after a step it has not saved;
                    the supervisor restarts the gang (cause crash), which
                    resumes from the last committed step -> bit-exact
  sigterm_preempt   the scheduler's SIGTERM on the launcher (a CLI
                    ``python -m paddle_tpu_torch.parallel.launch``), which
                    forwards it: the workers checkpoint and exit 0, the
                    launcher returns 0; a relaunch resumes -> bit-exact
  corrupt_shard     the baseline's newest step gets a truncated leaf and an
                    uncommitted later step is planted; the rerun restores
                    the older committed step -> bit-exact
  dp_reshard        a dp-2 reduce-scatter save restored at dp 1 (the flat
                    moments resharded through the manifest's layouts):
                    the params' crc32 and every moment leaf's equal
                    across the reshard, the final loss within 5% of the
                    baseline's
  hang              a worker stalls after a step; its watchdog fires within
                    the deadline, dumps the stacks and its flight ring and
                    exits 43; the supervisor restarts (cause hang) ->
                    bit-exact
  sigstop_blame     two ranks lock-step through a per-step file barrier
                    (the stand-in for the gradient all-reduce, stamped as
                    the flight collective ``allreduce_grads``); rank 1
                    SIGSTOPs itself before step 3's barrier, rank 0 wedges
                    in it and its watchdog fires; the supervisor's blame
                    pass must name rank 1 (``never_entered``) at seq 3
                    with no sequence gap, and set ``paddle_blamed_rank``
  poison_batch      (cpu) one dp rank's shard of one batch is NaN: every
                    rank skips that step alike (``health.nonfinite_guard``
                    on the all-reduced loss) -> bit-exact vs no poison
  divergence_rollback (cpu) a huge-lr fault; after K spike steps the
                    guard rolls back to the latest valid step with an LR
                    cooldown and the loss recovers
  straggler         (cpu) rank 1 of two sleeps each step; the
                    supervisor's heartbeat poll flags rank 1

Every worker keeps a goodput run window (model and step bring-up under
``compile``, saves under ``checkpoint_save``, the steps under
``productive_step``) exported to ``PADDLE_GOODPUT_DIR`` when it ends, and
records ``step_begin`` / ``step_end`` flight events into the sidecar under
``PADDLE_FLIGHT_DIR``. sigkill_midstep runs with both dirs: its
``GOODPUT.json`` must charge the restart to ``restart_downtime`` (equal to
the supervisor's ``restart_history`` window within 1 s) and give a gang
goodput fraction in (0, 1].

The card is the default: without arguments the card subset (baseline,
aa, sigkill_midstep, sigterm_preempt, corrupt_shard, hang, sigstop_blame,
dp_reshard) runs on GPT_SMALL's width at 2 of its 12 layers through the
port's
kernels (bf16, fused LN, vocab chunk 1024, dots remat, the flat AdamW
sweep, bf16 moments) at lr 1e-4 (``train_bench``'s; the reference's 1e-2,
sized for GPT_TINY, drives GPT_SMALL's loss up from 10.8 to 16), one rank
an NCCL world of one; the dp-2 save side of dp_reshard is two gloo ranks
sharing ``cuda:0``; sigstop_blame's two ranks train apart (each an NCCL
world of one on ``cuda:0``) at the reference's sizes for it (1 layer,
batch 2 x 8). Without a card it raises. ``--smoke --device cpu``
(the CPU test lane) runs every scenario on GPT_TINY at dp 2 over gloo.
The JSON record (every scenario, its pass, save / restore / recovery
times and each completed incarnation's kernel launches) goes where
``--out`` says.
"""
import argparse
import contextlib
import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "paddle_tpu_torch.tools.fault_bench"
T_IMPORT = time.time()
PG_TIMEOUT_S = 120.0     # every rendezvous and collective (> the deadline)
FAULT_RANK = 0           # the rank that dies, stalls or calls preemption
STRAGGLER_RANK = 1
SIGSTOP_AT, SIGSTOP_RANK = 3, 1
CUDA_LAYERS = 2          # the card lane's depth (GPT_SMALL's width)
GUARD_K = 2              # consecutive bad steps before a rollback
DIVERGE_LR = 30.0        # the injected divergence
POISON_AT, POISON_RANK, POISON_RANKS = 2, 2, 4


def _log(msg):
    print(f"[fault_bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Worker: one training incarnation (spawned through parallel.launch)
# ---------------------------------------------------------------------------

def _batch(step, vocab, batch, seqlen):
    """The global batch of step ``step``: a function of the step alone."""
    import numpy as np

    rng = np.random.default_rng(1000 + step)
    toks = rng.integers(0, vocab, (1, batch, seqlen), dtype=np.int64)
    labs = rng.integers(0, vocab, (1, batch, seqlen), dtype=np.int64)
    return toks, labs


def _crc(t, crc=0):
    """crc32 of a tensor's bytes (bf16 as its raw words)."""
    import torch

    return zlib.crc32(t.detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes(), crc)


def _params_crc(params, mesh, specs):
    """crc32 over every full param leaf in tree order (rank 0's; the
    gathers are collectives)."""
    from paddle_tpu_torch.parallel import checkpoint as C

    crc = 0
    for key, leaf in C.flatten_with_keys(params):
        spec = specs.get(f"['params']{key}")
        full = C._gather_full(leaf, spec, mesh) if spec else leaf
        crc = _crc(full, crc)
    return crc


def _moment_leaf_crcs(opt, layout, repl, mesh):
    """Per-leaf crc32 of the flat moments m and v: the layout-free identity
    of the optimizer state (equal across a reshard)."""
    from paddle_tpu_torch.parallel import checkpoint as C

    out = {}
    for name in ("m", "v"):
        full = C._gather_full(opt[name], (tuple(mesh.axis_names),), mesh)
        flat = C.reshard_flat(full.cpu(), layout, layout, src_repl=repl,
                              dst_repl=1)
        off = 0
        for b in layout.buckets:
            for idx, _shape, numel in b.entries:
                out[f"{name}{idx}"] = _crc(flat[off:off + numel])
                off += numel
            off += b.pad
    return out


def _config(args):
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.tools import train_bench as TB

    if args.device == "cpu":
        return G.GPT_TINY.scaled(num_layers=args.layers)
    cfg = TB.bench_config(remat_policy="dots", fused_ln=True, ce_vchunk=1024)
    return cfg.scaled(num_layers=args.layers) if args.layers else cfg


def _gang_barrier(barrier_dir, attempt, step, rank, trainers,
                  timeout_s=300.0):
    """File-based per-step gang barrier. sigstop_blame's ranks train
    apart (no process group between them), so this stands in for the
    blocking gradient all-reduce: each rank drops an attempt-prefixed
    marker and waits for the whole gang. A SIGSTOPped peer never writes
    its marker, so the healthy rank stalls here as in a wedged collective
    — its progress stamps stop, its watchdog fires, and its flight file
    ends in a ``coll_enter`` the peer never reached."""
    os.makedirs(barrier_dir, exist_ok=True)
    mine = os.path.join(barrier_dir, f"a{attempt}.s{step}.r{rank}")
    with open(mine, "w") as f:
        f.write(str(os.getpid()))
    deadline = time.time() + timeout_s
    want = [os.path.join(barrier_dir, f"a{attempt}.s{step}.r{r}")
            for r in range(trainers)]
    while time.time() < deadline:
        if all(os.path.exists(p) for p in want):
            return
        time.sleep(0.02)
    raise TimeoutError(f"gang barrier timed out at step {step}")


def _fault_marker(args, what):
    """True (and the marker written, with this moment) the first time an
    incarnation reaches its fault; the restarted ones run clean."""
    if not args.once_marker or os.path.exists(args.once_marker):
        return False
    with open(args.once_marker, "w") as f:
        json.dump({"pid": os.getpid(), "t": time.time(), "what": what}, f)
    return True


def worker(args):
    import numpy as np
    import torch

    from paddle_tpu_torch.observability import flight, goodput
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.parallel import checkpoint as C
    from paddle_tpu_torch.parallel import env, health
    from paddle_tpu_torch.parallel import parallelize as PZ
    from paddle_tpu_torch.parallel.launch import install_preemption_handler

    preempt = install_preemption_handler()
    # the goodput run window: this incarnation's wall clock, exported per
    # rank when it ends (a SIGKILLed one never exports: its lost time is
    # the supervisor's restart_downtime)
    led = goodput.ledger()
    led.start_window()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", 0))
    # the flight sidecar under PADDLE_FLIGHT_DIR, its meta record stamped
    # with this rank before an independent rank renames itself below
    flight.maybe_attach_from_env()
    independent = args.dp == 1 and trainers > 1
    result_path = args.result + (f".rank{rank}" if independent else "")
    ckpt_dir = (os.path.join(args.ckpt_dir, f"rank{rank}") if independent
                else args.ckpt_dir)
    if independent:
        # the straggler's ranks train alone, each a world of one
        os.environ.update({"PADDLE_TRAINERS_NUM": "1",
                           "PADDLE_TRAINER_ID": "0",
                           "PADDLE_TRAINER_ENDPOINTS": ""})
    if args.device == "cpu":
        torch.set_num_threads(1)
    device = None if args.device == "cuda" else args.device
    if independent and args.device == "cuda":
        device = "cuda:0"       # every rank a world of one on the card
    # process group, model and step bring-up: one-time start-up work,
    # charged to compile as the reference charges its bring-up
    with led.timer("compile"):
        dev = env.init_distributed_env(device=device,
                                       timeout_s=PG_TIMEOUT_S)
        stamps = {"t_import": T_IMPORT, "t_init": time.time()}
        base_lr = args.lr
        cfg = _config(args)
        pcfg = PZ.ParallelConfig(dp=args.dp)
        mesh = PZ.build_mesh(pcfg, device=dev)
        world = mesh.group(*mesh.axis_names)
        layout, repl = PZ.rs_param_layout(cfg, pcfg)
        params, opt = PZ.init_sharded(cfg, pcfg, mesh, seed=0,
                                      moment_dtype=torch.bfloat16,
                                      grad_reduce="reduce_scatter")
        specs = C.train_state_specs(cfg, pcfg, opt)

    def make_step(lr, skip=True):
        return PZ.make_train_step(cfg, pcfg, mesh, lr=lr,
                                  grad_reduce="reduce_scatter",
                                  skip_nonfinite=skip)

    with led.timer("compile"):
        step_fn = make_step(base_lr)
        bad_step_fn = make_step(DIVERGE_LR, False) if args.diverge_at \
            else None
    guard = (health.DivergenceGuard(health.GuardrailConfig(
        spike_mult=2.0, min_history=2, max_consecutive_bad=GUARD_K,
        lr_cooldown=0.5, max_rollbacks=2)) if args.diverge_at else None)
    ck = C.ElasticCheckpointer(ckpt_dir, keep_last=args.keep_last,
                               mesh=mesh)
    live_mesh = {"dp": args.dp, "pp": 1, "tp": 1}
    start, restored_from, reshard = 0, None, None
    restore_ms, restore_stats = None, None
    stamps["t_model"] = time.time()
    latest = ck.latest_valid_step()
    stamps["t_verify"] = time.time()
    t0 = time.perf_counter()
    if latest is not None:
        # a dp change is legal here (both layouts exist); another axis set
        # would raise MeshMismatchError
        params, opt, man = C.restore_train_state(
            ck, params, opt, layout=layout, layout_repl=repl, step=latest,
            mesh=mesh, specs=specs)
        restore_ms = (time.perf_counter() - t0) * 1e3
        restore_stats = dict(ck.last_restore)
        start = restored_from = int(man["step"])
        want = man.get("extra") or {}
        if "moment_leaf_crcs" in want:
            # the saved state's identity, whatever the dp it was saved at
            reshard = {
                "params": _params_crc(params, mesh, specs)
                == want["params_crc"],
                "moments": _moment_leaf_crcs(opt, layout, repl, mesh)
                == want["moment_leaf_crcs"]}
        _log(f"worker rank {rank} pid {os.getpid()} restored step {start} "
             f"in {restore_ms:.1f} ms (crcs equal to the save's: "
             f"{reshard})")
    inc = {"pid": os.getpid(), "rank": rank, "attempt": attempt,
           "start_step": start, "restored_from": restored_from,
           "reshard": reshard, "restore_ms": restore_ms,
           "verify_ms": (stamps["t_verify"] - stamps["t_model"]) * 1e3,
           "restore": restore_stats, **stamps, "t_ready": time.time(),
           "losses": [], "step_s": []}

    # the watchdog arms only now: init and the restore are behind us (the
    # step's first call, the first kernel use, runs with its clock paused)
    health.maybe_install_from_env()
    hb_dir = os.environ.get(health.ENV_DIR)
    heartbeat = (health.RankHeartbeat(hb_dir, rank, min_write_interval_s=0.2)
                 if hb_dir else None)

    def save(step_no):
        # the whole helper (the crc32s included) is checkpoint wall time
        with led.timer("checkpoint_save"):
            extra = ({"params_crc": _params_crc(params, mesh, specs),
                      "moment_leaf_crcs": _moment_leaf_crcs(
                          opt, layout, repl, mesh)}
                     if args.state_crcs else None)
            ck.save(step_no, {"params": params, "opt": opt},
                    mesh=live_mesh, layout=layout, layout_repl=repl,
                    specs=specs, data_state={"epoch": 0, "offset": step_no},
                    extra=extra)
            # committed before the next step: faults are injected against
            # "step N is committed" (the async overlap is in the tests)
            ck.wait()

    def export_goodput(**extra):
        # the real rank: an independent rank renamed itself 0 for its
        # world of one
        try:
            goodput.maybe_export(led.end_window(extra=dict(extra,
                                                           rank=rank)))
        except Exception:
            pass                  # accounting never fails the worker

    def finish_incarnation(**kw):
        inc.update(kw, saves=ck.history,
                   launches={k: v for k, v in CK.LAUNCHES.items() if v},
                   t_end=time.time())
        if rank == 0:
            with open(os.path.join(args.ckpt_dir, "incarnations.jsonl"),
                      "a") as f:
                f.write(json.dumps(inc) + "\n")

    def stop_requested():
        flag = torch.tensor([1.0 if preempt.triggered else 0.0],
                            device=dev)
        return float(world.all_reduce(flag)[0]) > 0

    loss, trajectory, rollback_restored_from = None, [], None
    injecting = bool(args.diverge_at)
    last_saved = start
    CK.reset_launches()
    for step in range(start + 1, args.steps + 1):
        if stop_requested():
            _log(f"worker rank {rank} preempted after step {step - 1}: "
                 "checkpoint + exit 0")
            if last_saved != step - 1:
                save(step - 1)
            ck.close()
            finish_incarnation(exit="preempt", final_step=step - 1)
            export_goodput(exit="preempt", final_step=step - 1)
            sys.exit(0)
        flight.event("step_begin", step=step)
        if args.straggle_ms and rank == STRAGGLER_RANK:
            time.sleep(args.straggle_ms / 1000.0)
        toks, labs = _batch(step, cfg.vocab_size, args.batch, args.seqlen)
        fn = bad_step_fn if injecting and step >= args.diverge_at \
            else step_fn
        t_step = time.perf_counter()
        params, opt, loss, _ = fn(params, opt, toks, labs)
        inc["losses"].append(float(loss))  # the step has run on the device
        inc["step_s"].append(round(time.perf_counter() - t_step, 4))
        if "t_first_step" not in inc:
            inc["t_first_step"] = time.time()
        if args.gang_barrier:
            if rank == SIGSTOP_RANK and step == SIGSTOP_AT and \
                    _fault_marker(args, "sigstop"):
                # freeze BEFORE the step's exchange: this rank's flight
                # file stops at seq N while its peer enters seq N + 1 and
                # wedges; SIGSTOP freezes this rank's watchdog too, so it
                # is the healthy peer's that fires
                _log(f"worker rank {rank} SIGSTOP before the barrier of "
                     f"step {step}")
                os.kill(os.getpid(), signal.SIGSTOP)
            # the first barrier waits for the peer's one-time start-up
            # work (its first step), which the watchdog does not judge
            with (health.suspend() if step == start + 1
                  else contextlib.nullcontext()), \
                    flight.collective("allreduce_grads", nbytes=8 * trainers):
                _gang_barrier(args.gang_barrier, attempt, step, rank,
                              trainers)
        if heartbeat is not None:
            heartbeat.beat(step)
        verdict = "ok"
        if guard is not None:
            lv = float(loss)
            trajectory.append(round(lv, 4))
            verdict = guard.judge(lv)
            if verdict == "rollback":
                latest = ck.latest_valid_step()
                _log(f"guardrail rollback at step {step} -> checkpoint "
                     f"{latest} (lr cooldown x{guard.config.lr_cooldown})")
                params, opt, _man = C.restore_train_state(
                    ck, params, opt, layout=layout, layout_repl=repl,
                    step=latest, mesh=mesh, specs=specs)
                guard.rolled_back()
                rollback_restored_from = latest
                # the injected fault ends at the rollback (a transient bad
                # segment); training goes on at the cooled rate
                injecting = False
                step_fn = make_step(base_lr * guard.config.lr_cooldown)
        if rank == FAULT_RANK and args.hang_at and \
                step == args.hang_at and _fault_marker(args, "hang"):
            _log(f"worker rank {rank} stalling after step {step} (the "
                 "watchdog should fire)")
            time.sleep(600)   # the watchdog os._exit()s before this returns
        if rank == FAULT_RANK and args.die_at and \
                step == args.die_at and _fault_marker(args, args.die_sig):
            if args.die_sig == "TERM":
                # the scheduler preempts the job: SIGTERM on the launcher,
                # which forwards it to every worker
                _log(f"worker rank {rank}: SIGTERM to the launcher after "
                     f"step {step}")
                os.kill(os.getppid(), signal.SIGTERM)
                deadline = time.time() + 60
                while not preempt.triggered and time.time() < deadline:
                    time.sleep(0.02)
            else:
                _log(f"worker rank {rank} self-injecting SIGKILL after "
                     f"step {step}")
                os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(30)
        if step % args.interval == 0 and verdict == "ok":
            # never save a step the guard judged bad: a rollback must
            # find a target from before the divergence
            save(step)
            last_saved = step
        flight.event("step_end", step=step)
    final_loss = float(loss) if loss is not None else None
    result = {"final_step": args.steps, "final_loss": final_loss,
              "params_crc": _params_crc(params, mesh, specs),
              "restored_from": restored_from,
              "reshard": reshard, "dp": args.dp}
    if heartbeat is not None:
        heartbeat.flush()
    if guard is not None:
        result.update(trajectory=trajectory,
                      guard_skipped=guard.skipped_steps,
                      guard_rollbacks=guard.rollbacks,
                      rollback_restored_from=rollback_restored_from)
    if last_saved != args.steps:
        save(args.steps)
    ck.close()
    finish_incarnation(exit="complete", final_step=args.steps)
    export_goodput(exit="complete", final_step=args.steps)
    if rank == 0 or independent:
        tmp = result_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, result_path)
    _log(f"worker rank {rank} done: loss {final_loss}")


def _leave_group():
    """Tear the process group down before the interpreter does: a gloo
    group left to exit-time destruction can abort the process ("terminate
    called without an active exception") after its work is done."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def poison_worker(args):
    """The reference's own toy model on dp ranks: a linear regression whose
    loss and gradient are all-reduced, ``health.nonfinite_guard`` on the
    summed loss deciding the skip before the update. One rank's shard of
    one batch is NaN; rank 0 records every rank's skip flags and both
    runs' final weights."""
    import numpy as np
    import torch

    from paddle_tpu_torch.parallel import env, health
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    env.init_distributed_env(device="cpu", backend="gloo",
                             timeout_s=PG_TIMEOUT_S)
    mesh = mesh_mod.build_mesh([("dp", -1)], device="cpu")
    dp = mesh.group("dp")
    n, r = dp.size, dp.index
    batch, din = 4, 8
    w_true = np.random.default_rng(7).standard_normal(din).astype(np.float32)

    def make_batch(i, poisoned):
        g = np.random.default_rng(100 + i)
        x = g.standard_normal((n * batch, din)).astype(np.float32)
        y = (x @ w_true + 0.01 * g.standard_normal(n * batch)
             ).astype(np.float32)
        if poisoned:
            x = x.copy()
            x[POISON_RANK * batch:(POISON_RANK + 1) * batch] = np.nan
        sl = slice(r * batch, (r + 1) * batch)
        return torch.from_numpy(x[sl]), torch.from_numpy(y[sl])

    def run(poison):
        w = torch.zeros(din, dtype=torch.float32)
        flags, losses = [], []
        for i in range(args.steps):
            if not poison and i == POISON_AT:
                continue   # the clean run never sees that batch
            x, y = make_batch(i, poison and i == POISON_AT)
            wg = w.clone().requires_grad_()
            lval = torch.sum((x @ wg - y) ** 2)
            lval.backward()
            loss = dp.all_reduce(lval.detach().clone()) / (batch * n)
            g = dp.all_reduce(wg.grad.clone()) / (batch * n)
            bad = health.nonfinite_guard(loss)
            if not bad:
                w = w - 0.1 * g
            flags.append(dp.all_gather(torch.tensor([float(bad)]))
                         .bool().tolist())
            losses.append(float(loss))
        return w, flags, losses

    w_clean, _, _ = run(False)
    w_poison, flags, losses = run(True)
    if r == 0:
        with open(args.result, "w") as f:
            json.dump({"flags": flags, "losses": losses, "dp": n,
                       "bit_exact": w_clean.numpy().tobytes()
                       == w_poison.numpy().tobytes()}, f)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

_PORT_BAND = 256          # the ports one harness process hands out
_port_lock = threading.Lock()
_port_next = [0]


def _ephemeral_low() -> int:
    """The bottom of the kernel's ephemeral port range (read only)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _reserve_port() -> int:
    """A rendezvous port for a job. Not one the kernel handed out and this
    process released — under load another process's connection or gloo
    pair can take such a port before the job's store binds it — but one
    BELOW the kernel's ephemeral range, which the kernel never hands out,
    from a band of ports this process owns (by its pid), skipping any
    port something else holds. Successive jobs get successive ports, so a
    job never meets its predecessor's sockets in TIME_WAIT."""
    top = min(_ephemeral_low(), 32768)
    bands = max(1, (top - 10000) // _PORT_BAND)
    base = 10000 + (os.getpid() % bands) * _PORT_BAND
    with _port_lock:
        for _ in range(_PORT_BAND):
            port = base + _port_next[0]
            _port_next[0] = (_port_next[0] + 1) % _PORT_BAND
            if _bindable(port):
                return port
    raise RuntimeError(f"no free port in {base}-{base + _PORT_BAND - 1}")


def _worker_args(ns):
    return ["--worker"] + [f"--{k.replace('_', '-')}={v}"
                           for k, v in ns.items() if v is not None]


class _JobTimer:
    """A job's time limit: on expiry SIGTERM to this process while the
    launcher's trap holds it — the trap turns it into a stop of the gang
    (the job then fails for want of a result), so no job outlives its
    limit. Outside the trap (the job has just ended) the expiry is only
    recorded: the default action would end the harness itself."""

    def __init__(self, seconds):
        self.expired = False
        self._timer = threading.Timer(seconds, self._fire)
        self._timer.daemon = True

    def _fire(self):
        self.expired = True
        if signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, signal.SIG_IGN, None):
            os.kill(os.getpid(), signal.SIGTERM)

    def __enter__(self):
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()


def _read_json(path):
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def _incarnations(ckpt_dir):
    path = os.path.join(ckpt_dir, "incarnations.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _restart_causes():
    from paddle_tpu_torch.observability import default_registry

    snap = default_registry().snapshot()
    series = snap.get("paddle_restarts_total", {}).get("series", [])
    return {s["labels"][0]: s["value"] for s in series}


def _straggler_detections():
    from paddle_tpu_torch.observability import default_registry

    snap = default_registry().snapshot()
    series = snap.get("paddle_straggler_detected_total", {}) \
        .get("series", [])
    return {s["labels"][0]: s["value"] for s in series}


def _match(got, want):
    if got is None or want is None:
        return "missing"
    if got == want:
        return "bit_exact"
    return f"rel_diff={abs(got - want) / max(1e-12, abs(want)):.3e}"


def _save_times(incs):
    """Rank 0's saves over ``incs``: the synchronous snapshot (gather +
    device -> host) and the write (bytes, crc32, files, commit) apart."""
    saves = [s for i in incs for s in i.get("saves", [])
             if "write_ms" in s]
    return {"saves": len(saves),
            "snapshot_ms": [round(s["snapshot_ms"], 3) for s in saves],
            "write_ms": [round(s["write_ms"], 3) for s in saves],
            "bytes": saves[0]["bytes"] if saves else None}


def _startup(inc, t0):
    """Seconds from ``t0`` to each of an incarnation's stamps: the
    interpreter and imports, the process group, model and step, the
    store's verify, the restore, the first step."""
    return {k: round(inc[k] - t0, 3) for k in (
        "t_import", "t_init", "t_model", "t_verify", "t_ready",
        "t_first_step") if inc.get(k)}


def _recovery(inc_new, t_fault, t_fail=None, t_respawn=None):
    """Seconds from the fault (and from the supervisor's seeing it) to the
    new incarnation's first step, and its restore."""
    out = {"restore_ms": inc_new.get("restore_ms"),
           "verify_ms": inc_new.get("verify_ms"),
           "restore": inc_new.get("restore")}
    if t_respawn is not None:
        out["from_respawn_s"] = _startup(inc_new, t_respawn)
    if t_fault is not None and inc_new.get("t_first_step"):
        out["fault_to_first_step_s"] = round(
            inc_new["t_first_step"] - t_fault, 3)
    if t_fail is not None and inc_new.get("t_first_step"):
        out["restart_downtime_s"] = round(
            inc_new["t_first_step"] - t_fail, 3)
    return out


class Harness:
    def __init__(self, mode, device, work):
        self.work = work
        self.cuda = mode == "cuda"
        if self.cuda:
            # GPT_SMALL's width at 2 of its 12 layers: the depth is the
            # one cut, to keep chip_smoke.py's phase 12 short
            base = dict(dp=1, layers=CUDA_LAYERS, batch=16, seqlen=1024,
                        steps=6, interval=3, keep_last=2, lr=1e-4)
            self.die_at, self.deadline, self.job_s = 4, 10.0, 240.0
        else:
            base = dict(dp=2, layers=1, batch=4, seqlen=16, steps=4,
                        interval=2, keep_last=3, lr=1e-2)
            # a job takes ~10 s on an idle host and several times that on
            # a loaded one (each worker's imports alone): the limit is for
            # a wedged job, not a slow one
            self.die_at, self.deadline, self.job_s = 3, 3.0, 240.0
        base["device"] = device
        self.base = base
        self.backend = "nccl" if self.cuda else "gloo"
        self.launches, self.incarnations = {}, []
        self.scenarios = {}

    def ns(self, name, **over):
        ckpt = os.path.join(self.work, name)
        os.makedirs(ckpt, exist_ok=True)
        d = dict(self.base, ckpt_dir=ckpt,
                 result=os.path.join(self.work, f"{name}.json"))
        d.update(over)
        return d

    def job(self, ns, max_restarts=2, backend=None, nproc=None,
            grace_period_s=20.0, **kw):
        """One supervised job through ``launch``; (rc, result, timed
        out)."""
        from paddle_tpu_torch.parallel.launch import launch

        with _JobTimer(self.job_s) as timer:
            rc = launch(MODULE, _worker_args(ns), module=True,
                        nproc_per_node=nproc or ns["dp"],
                        started_port=_reserve_port(),
                        backend=backend or self.backend,
                        max_restarts=max_restarts, restart_backoff_s=0.2,
                        restart_backoff_max_s=1.0,
                        grace_period_s=grace_period_s, **kw)
        return rc, _read_json(ns["result"]), timer.expired

    def cli_job(self, ns, max_restarts=0):
        """One job through the CLI (``python -m
        paddle_tpu_torch.parallel.launch``) as a subprocess of its own."""
        cmd = [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
               "--nproc_per_node", str(ns["dp"]), "--backend", self.backend,
               "--started_port", str(_reserve_port()), "--grace_period", "60",
               "--max_restarts", str(max_restarts), "-m", MODULE,
               *_worker_args(ns)]
        proc = subprocess.Popen(cmd, cwd=REPO)
        try:
            rc = proc.wait(timeout=self.job_s)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
        return rc, _read_json(ns["result"])

    def count(self, name, incs, dp=None):
        """Add the launches of each completed incarnation of ``name``
        (rank 0's) and keep its steps beside them."""
        for inc in incs:
            self.incarnations.append({
                "scenario": name, "dp": dp or self.base["dp"],
                "steps": inc["final_step"] - inc["start_step"],
                "exit": inc.get("exit"), "launches": inc.get("launches")})
            for k, v in (inc.get("launches") or {}).items():
                self.launches[k] = self.launches.get(k, 0) + v

    def done(self, name, s):
        self.scenarios[name] = s
        _log(f"{name}: pass={s['pass']} "
             + json.dumps({k: v for k, v in s.items()
                           if k in ("match_baseline", "restored_from",
                                    "recovery", "rc", "reason")}))

    def run(self, names):
        for name in names:
            t0 = time.time()
            getattr(self, f"s_{name}")()
            self.scenarios[name]["elapsed_s"] = round(time.time() - t0, 1)
        return self.scenarios

    # -- scenarios ----------------------------------------------------------

    def s_baseline(self):
        ns = self.ns("baseline")
        rc, res, timed_out = self.job(ns, max_restarts=0)
        incs = _incarnations(ns["ckpt_dir"])
        self.count("baseline", incs)
        s = {"rc": rc, "result": res, "timed_out": timed_out,
             "incarnations": len(incs), "save": _save_times(incs),
             "launches": incs and incs[0]["launches"]}
        s["pass"] = rc == 0 and res is not None and len(incs) == 1
        s["losses"] = incs[0]["losses"] if incs else []
        s["step_s"] = incs[0]["step_s"] if incs else []
        s["startup"] = incs and _startup(incs[0], incs[0]["t_import"])
        self.baseline, self.baseline_losses = res, s["losses"]
        self.done("baseline", s)

    def _vs_baseline(self, s, res):
        b = self.baseline or {}
        s["match_baseline"] = _match(res and res["final_loss"],
                                     b.get("final_loss"))
        s["params_match"] = bool(res) and \
            res["params_crc"] == b.get("params_crc")
        return s["match_baseline"] == "bit_exact" and s["params_match"]

    def s_aa(self):
        ns = self.ns("aa")
        rc, res, _ = self.job(ns, max_restarts=0)
        incs = _incarnations(ns["ckpt_dir"])
        self.count("aa", incs)
        s = {"rc": rc, "result": res}
        s["pass"] = rc == 0 and self._vs_baseline(s, res)
        self.done("aa", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def _expect_restore(self):
        b = self.base
        return (self.die_at // b["interval"]) * b["interval"]

    def s_sigkill_midstep(self):
        from paddle_tpu_torch.parallel.launch import restart_history

        n0 = len(restart_history())
        marker = os.path.join(self.work, "sigkill.marker")
        ns = self.ns("sigkill_midstep", die_at=self.die_at, die_sig="KILL",
                     once_marker=marker)
        gp_dir = os.path.join(self.work, "sigkill_goodput")
        before = _restart_causes()
        rc, res, timed_out = self.job(
            ns, max_restarts=2, goodput_dir=gp_dir,
            flight_dir=os.path.join(self.work, "sigkill_flight"))
        after = _restart_causes()
        incs = _incarnations(ns["ckpt_dir"])
        self.count("sigkill_midstep", incs)
        hist = restart_history()[n0:]
        fault = _read_json(marker) or {}
        gp = _read_json(os.path.join(gp_dir, "GOODPUT.json"))
        s = {"rc": rc, "result": res, "timed_out": timed_out,
             "incarnations": len(incs) + 1,
             "restarts": hist, "restored_from": [i["restored_from"]
                                                 for i in incs],
             "expected_restore": self._expect_restore(),
             "crash_restarts": after.get("crash", 0)
             - before.get("crash", 0), "goodput": gp}
        if incs and hist:
            s["recovery"] = _recovery(incs[-1], fault.get("t"),
                                      hist[0]["t_fail"],
                                      hist[0]["t_respawn"])
        frac = gp and gp.get("gang_goodput_fraction")
        s["gang_goodput_fraction"] = frac
        s["goodput_downtime_s"] = gp and gp.get("restart_downtime_s")
        s["history_downtime_s"] = round(sum(
            h["t_respawn"] - h["t_fail"] for h in hist), 6)
        # the report charges the supervisor's failure -> respawn window,
        # the window restart_history() keeps
        s["downtime_agrees"] = bool(
            gp and gp["categories"].get("restart_downtime", 0) > 0
            and abs(s["goodput_downtime_s"] - s["history_downtime_s"])
            <= 1.0)
        ok = self._vs_baseline(s, res)
        s["pass"] = bool(rc == 0 and ok and len(hist) == 1
                         and hist[0]["cause"] == "crash"
                         and s["crash_restarts"] == 1 and incs
                         and incs[-1]["restored_from"]
                         == s["expected_restore"]
                         and frac is not None and 0 < frac <= 1
                         and s["downtime_agrees"])
        self.done("sigkill_midstep", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_sigterm_preempt(self):
        marker = os.path.join(self.work, "sigterm.marker")
        ns = self.ns("sigterm_preempt", die_at=self.die_at, die_sig="TERM",
                     once_marker=marker)
        rc1, res1 = self.cli_job(ns)
        preempted_clean = rc1 == 0 and res1 is None
        rc2, res, timed_out = self.job(ns, max_restarts=0)
        incs = _incarnations(ns["ckpt_dir"])
        self.count("sigterm_preempt", incs)
        fault = _read_json(marker) or {}
        s = {"rc_preempted": rc1, "rc_resumed": rc2, "timed_out": timed_out,
             "preempted_clean_exit": preempted_clean, "result": res,
             "exits": [i.get("exit") for i in incs],
             "restored_from": [i["restored_from"] for i in incs]}
        if len(incs) == 2:
            s["recovery"] = _recovery(incs[-1], fault.get("t"))
            s["preempt_save"] = _save_times(incs[:1])
        ok = self._vs_baseline(s, res)
        s["pass"] = bool(preempted_clean and rc2 == 0 and ok
                         and s["exits"] == ["preempt", "complete"]
                         and s["restored_from"] == [None, self.die_at])
        self.done("sigterm_preempt", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_corrupt_shard(self):
        """The baseline's store: its newest committed step gets a truncated
        leaf and a later uncommitted step is planted; the rerun must pick
        the older committed step."""
        from paddle_tpu_torch.parallel.checkpoint import ElasticCheckpointer

        ns = self.ns("baseline",
                     result=os.path.join(self.work, "corrupt_shard.json"))
        ck = ElasticCheckpointer(ns["ckpt_dir"])
        steps = ck.all_steps()
        n_inc = len(_incarnations(ns["ckpt_dir"]))
        s = {"steps_before": steps}
        if len(steps) < 2:
            s.update(reason="the baseline left fewer than 2 steps",
                     **{"pass": False})
            self.done("corrupt_shard", s)
            return
        newest, expect = steps[-1], steps[-2]
        shard = os.path.join(ns["ckpt_dir"], f"step_{newest:08d}",
                             "leaves", "leaf_0.bin")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
        partial = os.path.join(ns["ckpt_dir"], f"step_{newest + 2:08d}",
                               "leaves")
        os.makedirs(partial)
        with open(os.path.join(partial, "leaf_0.bin"), "wb") as f:
            f.write(b"\x00" * 128)   # a mid-save kill: leaves, no COMMIT
        rc, res, timed_out = self.job(ns, max_restarts=1)
        incs = _incarnations(ns["ckpt_dir"])[n_inc:]
        self.count("corrupt_shard", incs)
        restored = incs[-1]["restored_from"] if incs else None
        s.update(rc=rc, result=res, timed_out=timed_out,
                 corrupted_step=newest, planted_partial_step=newest + 2,
                 restored_from=restored, expected_restore=expect,
                 no_partial_selected=restored == expect)
        if incs:
            s["restore_ms"] = incs[-1]["restore_ms"]
        ok = self._vs_baseline(s, res)
        s["pass"] = bool(rc == 0 and s["no_partial_selected"] and ok)
        self.done("corrupt_shard", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_hang(self):
        from paddle_tpu_torch.parallel.launch import restart_history

        n0 = len(restart_history())
        health_dir = os.path.join(self.work, "hang_health")
        marker = os.path.join(self.work, "hang.marker")
        ns = self.ns("hang", hang_at=self.die_at, once_marker=marker)
        before = _restart_causes()
        rc, res, timed_out = self.job(
            ns, max_restarts=2, hang_deadline_s=self.deadline,
            health_dir=health_dir)
        after = _restart_causes()
        incs = _incarnations(ns["ckpt_dir"])
        self.count("hang", incs)
        hist = restart_history()[n0:]
        dumps = sorted(glob.glob(os.path.join(health_dir, "hang_*",
                                              "hang_info.json")))
        flight_dumps = sorted(glob.glob(os.path.join(
            health_dir, "hang_*", "flight.dump.hang.*.json")))
        infos = [_read_json(p) for p in dumps]
        fault = _read_json(marker) or {}
        s = {"rc": rc, "result": res, "timed_out": timed_out,
             "deadline_s": self.deadline,
             "hang_restarts": after.get("hang", 0) - before.get("hang", 0),
             "stack_dumps": len(dumps), "flight_dumps": len(flight_dumps),
             "restored_from": [i["restored_from"] for i in incs],
             "expected_restore": self._expect_restore(), "restarts": hist}
        if infos and fault.get("t"):
            first = min(infos, key=lambda i: i["ts"])
            s["detection_s"] = round(first["ts"] - fault["t"], 3)
            s["last_progress_age_s"] = first["last_progress_age_s"]
            s["site"] = first["site"]
        if incs and hist:
            s["recovery"] = _recovery(incs[-1], fault.get("t"),
                                      hist[0]["t_fail"],
                                      hist[0]["t_respawn"])
        ok = self._vs_baseline(s, res)
        s["pass"] = bool(rc == 0 and s["hang_restarts"] == 1 and dumps
                         and flight_dumps
                         and hist and hist[0]["cause"] == "hang"
                         and s.get("last_progress_age_s", 0)
                         > self.deadline
                         and incs and incs[-1]["restored_from"]
                         == s["expected_restore"] and ok)
        self.done("hang", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_sigstop_blame(self):
        """Two ranks at the reference's sizes for this scenario (1 layer,
        batch 2 x 8, 5 steps, a 4 s hang deadline) train apart, lock-
        stepped by the flight-stamped file barrier; rank 1 SIGSTOPs itself
        before step 3's. The supervisor kills the gang (SIGKILL reaches a
        stopped process, after a short grace), runs the blame pass and
        restarts; the rerun completes."""
        from paddle_tpu_torch.observability import default_registry

        fl_health = os.path.join(self.work, "sigstop_health")
        ns = self.ns("sigstop_blame", dp=1, layers=1, batch=2, seqlen=8,
                     steps=5, interval=100,
                     gang_barrier=os.path.join(self.work, "sigstop_barrier"),
                     once_marker=os.path.join(self.work, "sigstop.marker"))
        before = _restart_causes()
        rc, _res, timed_out = self.job(
            ns, max_restarts=2, nproc=2, hang_deadline_s=4.0,
            health_dir=fl_health, grace_period_s=2.0)
        after = _restart_causes()
        blame_path = os.path.join(fl_health, "flight", "blame.attempt0.json")
        verdict = (_read_json(blame_path) or {}).get("verdict") or {}
        series = default_registry().snapshot().get(
            "paddle_blamed_rank", {}).get("series", [])
        gauge = series[0]["value"] if series else None
        s = {"rc": rc, "timed_out": timed_out,
             "hang_restarts": after.get("hang", 0) - before.get("hang", 0),
             "blame_report": os.path.exists(blame_path),
             "blamed_ranks": verdict.get("blamed_ranks"),
             "blame_mode": verdict.get("blame_mode"),
             "missed_seq": verdict.get("missed_seq"),
             "missed_name": verdict.get("missed_name"),
             "expected_missed_seq": SIGSTOP_AT,
             "seq_gaps_total": verdict.get("seq_gaps_total"),
             "step_skew_ms": verdict.get("step_skew_ms"),
             "paddle_blamed_rank": gauge}
        s["pass"] = bool(rc == 0 and s["hang_restarts"] >= 1
                         and s["blamed_ranks"] == [SIGSTOP_RANK]
                         and s["blame_mode"] == "never_entered"
                         and s["missed_seq"] == SIGSTOP_AT
                         and s["missed_name"] == "allreduce_grads"
                         and s["seq_gaps_total"] == 0
                         and gauge == SIGSTOP_RANK)
        self.done("sigstop_blame", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_dp_reshard(self):
        b = self.base
        half = b["steps"] // 2
        ns = self.ns("dp_reshard", steps=half, dp=2, state_crcs=1,
                     device="cuda:0" if self.cuda else b["device"])
        rc1, _, t1 = self.job(ns, max_restarts=0, backend="gloo")
        save_incs = _incarnations(ns["ckpt_dir"])
        self.count("dp_reshard", save_incs, dp=2)
        if os.path.exists(ns["result"]):
            os.remove(ns["result"])
        ns2 = dict(ns, steps=b["steps"], dp=1, device=b["device"])
        rc2, res, t2 = self.job(ns2, max_restarts=0)
        incs = _incarnations(ns["ckpt_dir"])[len(save_incs):]
        self.count("dp_reshard", incs, dp=1)
        s = {"rc_save_dp": rc1, "rc_restore_dp": rc2,
             "timed_out": t1 or t2, "save_dp": 2, "restore_dp": 1,
             "result": res, "save": _save_times(save_incs),
             "reshard": res and res["reshard"]}
        s["reshard_bit_exact"] = s["reshard"] == {"params": True,
                                                  "moments": True}
        if incs:
            s["restore_ms"] = incs[-1]["restore_ms"]
            s["restore"] = incs[-1]["restore"]
        # each step's loss beside the baseline's (dp 2, then dp 1)
        base_losses = self.baseline_losses
        losses = [x for i in save_incs[:1] + incs[-1:]
                  for x in i.get("losses", [])]
        s["loss_rel_diff_by_step"] = [
            abs(a - b) / max(1e-12, abs(b))
            for a, b in zip(losses, base_losses)]
        bl = (self.baseline or {}).get("final_loss")
        s["match_baseline"] = _match(res and res["final_loss"], bl)
        loss_ok = bool(res) and bl is not None and abs(
            res["final_loss"] - bl) < 0.05 * max(1.0, abs(bl))
        s["pass"] = bool(rc1 == 0 and rc2 == 0 and s["reshard_bit_exact"]
                         and loss_ok)
        self.done("dp_reshard", s)
        shutil.rmtree(ns["ckpt_dir"], ignore_errors=True)

    def s_poison_batch(self):
        poison_at, n = POISON_AT, POISON_RANKS
        res_path = os.path.join(self.work, "poison_batch.json")
        args = ["--poison-worker", f"--result={res_path}", "--steps=6"]
        from paddle_tpu_torch.parallel.launch import launch

        with _JobTimer(self.job_s) as timer:
            rc = launch(MODULE, args, module=True, nproc_per_node=n,
                        started_port=_reserve_port(), backend="gloo",
                        grace_period_s=10.0)
        res = _read_json(res_path) or {}
        flags = res.get("flags") or []
        s = {"rc": rc, "timed_out": timer.expired, "dp": n,
             "poison_step": poison_at, "poison_rank": POISON_RANK,
             "per_rank_skip_flags_at_poison": flags[poison_at]
             if len(flags) > poison_at else None,
             "weights_bit_exact_vs_no_poison": res.get("bit_exact")}
        s["all_ranks_skipped_identically"] = bool(
            s["per_rank_skip_flags_at_poison"]) and all(
            s["per_rank_skip_flags_at_poison"])
        s["no_other_step_skipped"] = bool(flags) and not any(
            any(f) for i, f in enumerate(flags) if i != poison_at)
        s["pass"] = bool(rc == 0 and s["all_ranks_skipped_identically"]
                         and s["no_other_step_skipped"]
                         and res.get("bit_exact"))
        self.done("poison_batch", s)

    def s_divergence_rollback(self):
        import math

        b = self.base
        ns = self.ns("divergence_rollback", steps=b["steps"] + 2,
                     diverge_at=self.die_at)
        rc, res, timed_out = self.job(ns, max_restarts=0)
        traj = (res or {}).get("trajectory") or []
        peak = max(traj) if traj else None
        expect_rb = ((self.die_at - 1) // b["interval"]) * b["interval"]
        final = (res or {}).get("final_loss")
        bl = (self.baseline or {}).get("final_loss")
        s = {"rc": rc, "timed_out": timed_out, "trajectory": traj,
             "peak_loss": peak, "skipped": (res or {}).get("guard_skipped"),
             "rollbacks": (res or {}).get("guard_rollbacks"),
             "rollback_restored_from":
                 (res or {}).get("rollback_restored_from"),
             "expected_rollback_target": expect_rb, "final_loss": final}
        s["recovered"] = bool(final is not None and math.isfinite(final)
                              and peak is not None and final < 0.5 * peak
                              and bl is not None and final <= bl * 1.25)
        s["pass"] = bool(rc == 0 and s["rollbacks"] == 1
                         and s["skipped"] == 2
                         and s["rollback_restored_from"] == expect_rb
                         and s["recovered"])
        self.done("divergence_rollback", s)

    def s_straggler(self):
        from paddle_tpu_torch.parallel import health

        sg_health = os.path.join(self.work, "straggler_health")
        ns = self.ns("straggler", straggle_ms=250,
                     steps=24, interval=100, dp=1, layers=1, batch=2,
                     seqlen=8)
        before = _straggler_detections()
        rc, _, timed_out = self.job(
            ns, max_restarts=0, nproc=2, health_dir=sg_health,
            straggler_warn_cooldown_s=5.0)
        after = _straggler_detections()
        findings = health.detect_stragglers(sg_health, ratio=2.0)
        s = {"rc": rc, "timed_out": timed_out,
             "rank1_detections": after.get("1", 0) - before.get("1", 0),
             "rank0_detections": after.get("0", 0) - before.get("0", 0),
             "final_heartbeat_findings": findings,
             "flagged_ranks": sorted({f["rank"] for f in findings})}
        s["pass"] = bool(rc == 0 and s["rank1_detections"] >= 1
                         and s["rank0_detections"] == 0
                         and s["flagged_ranks"] == [1])
        self.done("straggler", s)


SCENARIOS = {
    "smoke": ("baseline", "aa", "sigkill_midstep", "sigterm_preempt",
              "corrupt_shard", "dp_reshard", "hang", "sigstop_blame",
              "poison_batch", "divergence_rollback", "straggler"),
    "cuda": ("baseline", "aa", "sigkill_midstep", "sigterm_preempt",
             "corrupt_shard", "hang", "sigstop_blame", "dp_reshard"),
}


def harness(device, out_path, only=None):
    from paddle_tpu_torch.device import resolve_device

    t0 = time.time()
    mode = "smoke" if resolve_device(device).type == "cpu" else "cuda"
    # sigstop_blame stops a worker of this process's group; when another
    # member exits, a kernel may send the (orphaned) group SIGHUP and
    # SIGCONT. The supervisor survives it; the workers keep the default
    # action (a handler, unlike an ignored signal, is reset across exec),
    # so the stopped rank dies of it where it stood
    signal.signal(signal.SIGHUP, lambda signum, frame: _log(
        "SIGHUP to the gang's process group (a stopped member) ignored"))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if mode == "cuda":
        # build the kernels once, before any gang: restarted workers load
        # the cached library and never race an nvcc build
        from paddle_tpu_torch.ops import _build

        info = _build.build()
        _log(f"kernels {info.path} (cached={info.cached}, "
             f"{info.seconds:.1f} s)")
    work = tempfile.mkdtemp(prefix="fault_bench_")
    _log(f"workdir {work} (mode {mode})")
    h = Harness(mode, device, work)
    try:
        scenarios = h.run(only or SCENARIOS[mode])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = all(s["pass"] for s in scenarios.values())
    out = {"mode": mode, "device": device, "config": h.base,
           "elapsed_s": round(time.time() - t0, 1),
           "scenarios": scenarios, "launches": h.launches,
           "incarnations": h.incarnations,
           "pass": bool(ok)}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    _log(f"pass={ok} in {out['elapsed_s']} s")
    print(json.dumps({"fault_bench": out_path, "pass": bool(ok),
                      "mode": mode, "elapsed_s": out["elapsed_s"]}))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.fault_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--poison-worker", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU lane: every scenario on GPT_TINY over "
                         "gloo (with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the card subset at GPT_SMALL width (a "
                         "worker may be given cuda:0); cpu with --smoke")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenarios (baseline first)")
    # worker knobs
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--result")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--interval", type=int, default=2)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--state-crcs", type=int, default=0,
                    help="record the params' crc32 and every moment "
                         "leaf's in each save (the reshard's proof)")
    ap.add_argument("--die-at", type=int, default=0)
    ap.add_argument("--die-sig", default="KILL", choices=("KILL", "TERM"))
    ap.add_argument("--once-marker")
    ap.add_argument("--hang-at", type=int, default=0)
    ap.add_argument("--straggle-ms", type=int, default=0)
    ap.add_argument("--gang-barrier", default=None,
                    help="a per-step file barrier among independent ranks, "
                         "stamped as the flight collective allreduce_grads "
                         "(rank 1 SIGSTOPs before step 3's with "
                         "--once-marker)")
    ap.add_argument("--diverge-at", type=int, default=0)
    args = ap.parse_args(argv)
    if args.worker or args.poison_worker:
        try:
            (worker if args.worker else poison_worker)(args)
        finally:
            _leave_group()
        return 0
    if args.smoke != (args.device == "cpu"):
        ap.error("the CPU runs the smoke lane only: give --smoke with "
                 "--device cpu, neither for the card")
    only = args.only.split(",") if args.only else None
    return harness(args.device, args.out, only)


if __name__ == "__main__":
    sys.exit(main())
