"""A test process's share of the machine, and the time limits of what it
waits for. Every tests/test_torch_*.py imports this module.

Threads: each pytest worker of a parallel run (pytest-xdist sets
PYTEST_XDIST_WORKER_COUNT) takes cpu_count // workers of torch's
intra-op threads, at least one, instead of one per core each (six
workers on 8 cores kept 48 compute threads busy, and every file ran
several times slower). Child interpreters get the same share through
`child_env`.

Waits: a child process, a thread or an in-process entry point (a CLI's
main) that a test waits for gets a limit of its own, a few times its
normal time and well under the suite's; past it the test fails, naming
what it waited for with the tail of its output, and kills the child (a
thread is left behind as a daemon), so that no wait stops the clock of
the whole suite. The longest child (tests/test_torch_no_jax.py's disk
path) takes about 16 s on 8 cores under six workers, the longest CLI
(tests/test_torch_cli.py's curriculum) about 48 s.
"""

import os
import subprocess
import threading
import time

import pytest
import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
CHILD_TIMEOUT = 120       # seconds a test's child processes may take
TAIL = 3000               # characters of a child's output a failure shows

torch.set_num_threads(THREADS)


def child_env(env=None) -> dict:
    """A copy of `env` (os.environ by default) with the thread variables of
    a child interpreter set to this process's share."""
    env = dict(os.environ if env is None else env)
    env.update({v: str(THREADS) for v in THREAD_VARS})
    return env


def _text(out) -> str:
    if out is None:
        return ""
    return out.decode(errors="replace") if isinstance(out, bytes) else out


def run_child(cmd, name: str, timeout: float = CHILD_TIMEOUT, **kw):
    """subprocess.run(cmd, capture_output=True, text=True, **kw) within
    `timeout` seconds; past it the child is killed and the test fails
    naming it, with the tail of its output."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, **kw)
    except subprocess.TimeoutExpired as e:
        out = _text(e.stdout) + _text(e.stderr)
        pytest.fail(f"{name} did not finish within {timeout} s; the tail "
                    f"of its output:\n{out[-TAIL:]}")


def wait_children(children, timeout: float = CHILD_TIMEOUT) -> list:
    """children: [(name, Popen, log path or None)]. Waits for them in turn
    within one deadline of `timeout` seconds (communicating with those
    whose output is piped) and stops at the first that fails; every child
    still running then is killed. Past the deadline the test fails naming
    the children that had not finished, with the tail of each one's log or
    output. Returns [(return code, stdout, stderr)] of those that
    finished, in order."""
    deadline = time.monotonic() + timeout
    done, killed, late = [], {}, False
    try:
        for name, proc, _ in children:
            try:
                out, err = proc.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late = True
                break
            done.append((proc.returncode, _text(out), _text(err)))
            if proc.returncode != 0:
                break
    finally:
        for name, proc, _ in children:
            if proc.poll() is None:
                proc.kill()
                out, err = proc.communicate()
                killed[name] = _text(out) + _text(err)
    if late:
        tails = []
        for name, _, log in children:
            if name not in killed:
                continue
            text = killed[name]
            if log is not None and os.path.exists(log):
                with open(log, errors="replace") as f:
                    text = f.read()
            tails.append(f"--- {name}\n{text[-TAIL:]}")
        pytest.fail(f"{', '.join(killed)} did not finish within {timeout} "
                    f"s\n" + "\n".join(tails))
    return done


def join_threads(threads, what: str, timeout: float = 30.0) -> None:
    """Joins the threads within one deadline; fails naming those still
    running (start them as daemons, so that one that hangs does not hold
    the worker's exit)."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        pytest.fail(f"{what}: threads {alive} still running after "
                    f"{timeout} s")


def within(fn, what: str, timeout: float = CHILD_TIMEOUT):
    """fn() run on a daemon thread within `timeout` seconds: its result,
    or its exception raised again here; past the limit the test fails
    naming `what` (the thread is left to finish or to hang on its own)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:          # SystemExit too: re-raised here
            box["err"] = e
    t = threading.Thread(target=run, name=what, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"{what} did not finish within {timeout} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")
