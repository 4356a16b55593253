"""A cell whose configuration's ``layout`` asks for several ranks runs as
that many processes on the host, one card each (``cuda:<rank>``), joined
in the program's process group on localhost (its
``parallel.distributed.initialize_cluster``); where every rank holds a
card, the program opens its NCCL group and moves its halo strips and
maxima card to card itself.  ``launch`` starts the ranks and waits for
them; each runs ``main``, which joins the group and runs
``harness.run_cell``.

Rank 0's standard error passes through as it is written; its standard
output, which ends with the result line, is relayed once every rank has
ended with 0, so a failed run prints no result.  The other ranks write
both into files of the run's directory, whose ends are printed on
standard error when a rank fails.  A rank that ends with another code
than 0 ends the whole run: the others are killed with their process
groups at once.  The program's collectives and its rendezvous give up
after its own time limit (two minutes), which ends a rank that waits for
one that hangs; ``DEADLINE_S`` ends a run that is still going.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEADLINE_S = 1150.0     # inside the first run's 1200 s, which compiles
POLL_S = 0.1
TAIL = 4000             # characters of a failed rank's output printed


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs):
    """Kill each process still running, with its process group, and wait
    for every one."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def _wait(procs, deadline):
    """0 once every process has ended with 0; else the first other code
    (1 for a process killed by a signal), or 124 at ``deadline``."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            return bad[0] if bad[0] > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        if time.perf_counter() > deadline:
            return 124
        time.sleep(POLL_S)


def _tail(path):
    text = Path(path).read_text(errors="replace")
    return text[-TAIL:]


def launch(opts, ranks, *, entry=None, stdout=None, deadline_s=DEADLINE_S):
    """Run ``ranks`` ranks of the cell that ``opts`` names (``run_cell``'s
    ``workload``, ``seed``, ``seconds`` and ``trace``; the tests add
    ``device``, ``root``, ``sizes`` and ``limits``) and return the run's
    exit code.  ``entry`` is the command that starts a rank, before its
    options (by default this file under the running Python); ``stdout``
    takes rank 0's standard output (by default this process's)."""
    stdout = stdout or sys.stdout
    deadline = time.perf_counter() + deadline_s
    workdir = Path(tempfile.mkdtemp(prefix="portbench-",
                                    dir=os.environ.get("TMPDIR")))
    addr = f"127.0.0.1:{_free_port()}"
    entry = entry or [sys.executable, str(HERE / "ranks.py")]
    procs, logs = [], [workdir / f"rank{r}.out" for r in range(ranks)]
    # A run that is ended from outside ends its ranks too.
    previous = signal.signal(signal.SIGTERM, _terminated)
    try:
        for r in range(ranks):
            own = dict(opts, rank=r, ranks=ranks, addr=addr,
                       workdir=str(workdir))
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [*entry, json.dumps(own)], stdout=out,
                    stderr=None if r == 0 else subprocess.STDOUT,
                    env=dict(os.environ, LOCAL_RANK=str(r)),
                    start_new_session=True))
        rc = _wait(procs, deadline)
        if rc != 0:
            _kill(procs)
            why = ("did not end within its deadline" if rc == 124
                   else "a rank failed")
            print(f"portbench: {why}; exit codes "
                  f"{[p.returncode for p in procs]}", file=sys.stderr)
            for r, p in enumerate(procs):
                if r > 0 and p.returncode != 0:
                    print(f"--- rank {r}, its output's end:\n"
                          + _tail(logs[r]), file=sys.stderr)
            return rc
        from portbench import harness
        loaded = harness.forbidden_loaded()
        if loaded:
            print(f"portbench: the launcher loaded what it may not: {loaded}",
                  file=sys.stderr)
            return 3
        stdout.write(logs[0].read_text())
        stdout.flush()
        return 0
    finally:
        _kill(procs)
        signal.signal(signal.SIGTERM, previous)
        shutil.rmtree(workdir, ignore_errors=True)


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None):
    """One rank: join the process group, run the cell; rank 0 prints the
    result line and the numbers compared."""
    opts = json.loads((argv or sys.argv[1:])[0])
    sys.path.insert(0, str(HERE.parent))
    from hipims_tpu_torch.parallel import distributed

    from portbench import harness

    distributed.initialize_cluster(opts["addr"], opts["ranks"],
                                   opts["rank"])
    try:
        platform = "cpu" if opts.get("device") == "cpu" else "gpu"
        distributed.open_groups(platform)
        result = harness.run_cell(
            opts["workload"], opts["seed"], opts["seconds"],
            bool(opts["trace"]),
            device=str(distributed.rank_device(platform)),
            sizes=opts.get("sizes"), limits=opts.get("limits"),
            t_start=opts.get("t_start"), root=opts.get("root"),
            workdir=opts["workdir"])
    except harness.ForbiddenModules as exc:
        print(f"portbench: rank {opts['rank']} loaded what it may not: "
              f"{exc}", file=sys.stderr)
        return 3
    finally:
        distributed.shutdown()
    if result is None:
        return 0
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded what it may not: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    harness.print_compared(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
