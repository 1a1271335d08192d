"""``chip_smoke.py``'s end-of-run sweep: no process the run started,
directly or not, outlives it. Runs on the CPU: the sweep finds the run's
processes by the variable every one of them inherits, not by the card."""
import os
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = textwrap.dedent("""
    import json, multiprocessing, os, subprocess, sys, time
    sys.path.insert(0, {repo!r})
    import chip_smoke as CS


    def idle():
        time.sleep(600)


    if __name__ == "__main__":
        os.environ[CS.RUN_TAG] = {tag!r}
        # an orphan in a session of its own (its parent exits at once)
        subprocess.Popen(["sh", "-c", "sleep 600 & exit 0"],
                         start_new_session=True).wait()
        # a plain child, a SIGSTOPped one, a spawned process (which
        # starts the resource tracker)
        subprocess.Popen(["sleep", "600"])
        subprocess.Popen(["sh", "-c", "kill -STOP $$; sleep 600"])
        ctx = multiprocessing.get_context("spawn")
        ctx.Process(target=idle, daemon=True).start()
        deadline = time.time() + 60
        while len([p for p in CS._tagged_processes() if p[2] != "Z"]) < 5:
            assert time.time() < deadline, CS._tagged_processes()
            time.sleep(0.1)
        left = CS.stop_run_processes()
        print(json.dumps({{"left": [p[3] for p in left],
                          "after": CS._tagged_processes()}}))
""")


def _live_with(tag: str) -> list:
    mark = f"PTT_CHIP_SMOKE_RUN={tag}".encode()
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if stat[stat.rindex(")") + 2:].split()[0] != "Z":
            pids.append(int(d))
    return pids


def test_sweep_stops_every_process_of_the_run(tmp_path):
    import json

    tag = f"sweep-test-{os.getpid()}-{time.time_ns()}"
    script = tmp_path / "run.py"
    script.write_text(_RUN.format(repo=REPO, tag=tag))
    try:
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=60,
                             cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-4000:]
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        cmds = " | ".join(rec["left"])
        # the tracker ends by its own call; the other four are killed
        assert len(rec["left"]) == 4, cmds
        assert cmds.count("sleep 600") >= 2 and "spawn_main" in cmds, cmds
        assert not [p for p in rec["after"] if p[2] != "Z"], rec["after"]
        assert _live_with(tag) == []
    finally:
        for pid in _live_with(tag):
            os.kill(pid, 9)


def _chip_smoke_ast():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        return ast.parse(f.read())


def _feeds_launches(main, phase: str) -> bool:
    """Whether ``_main`` calls ``phase`` and a loop over its result (or
    over the record it returns) adds into ``launches``."""
    import ast

    bound = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", None) == phase:
            bound |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for node in ast.walk(main):
        if not isinstance(node, ast.For):
            continue
        it = ast.dump(node.iter)
        if f"id='{phase}'" not in it and not any(
                f"id='{b}'" in it for b in bound):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Subscript)
                    and getattr(t.value, "id", None) == "launches"
                    for t in sub.targets):
                return True
    return False


def test_fluid_amp_and_encoder_phases_present():
    """Phases 10a (ResNet-50 in bf16 AMP), 10e (the fluid encoder) and
    10ep (its card-vs-CPU parity) are defined, listed in the script's
    docstring, run by ``_main`` and feed the kernels line's launches;
    the script imports neither JAX nor the JAX package."""
    import ast

    tree = _chip_smoke_ast()
    doc = ast.get_docstring(tree)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for tag, phase in (("10a. resnet50-amp", "phase_resnet50_amp"),
                       ("10e. encoder", "phase_encoder"),
                       ("10ep. encoder-parity", "phase_encoder_parity")):
        assert tag in doc, tag
        assert phase in funcs, phase
        assert _feeds_launches(funcs["_main"], phase), phase
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "paddle_tpu"), n
