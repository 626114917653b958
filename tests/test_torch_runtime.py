"""The port's sweep runtime (``gnn_pretraining_tpu_torch/utils/runtime.py``)
on the CPU, held against ``gnn_pretraining_tpu/utils/runtime.py``.

  * the cases of ``tests/test_runtime.py`` against the port's
    ``reclaim_chip`` and ``write_pidfile``: a recorded process is reclaimed,
    a stale, garbled, recycled or foreign file is removed and nothing is
    signalled (both packages), a zombie counts as exited;
  * the pause handshake: a requester process takes the card from a sweep
    that parks at its chunk boundary and resumes on ``release_chip``; a
    request whose owner is gone is discarded (both packages);
  * the port's files are its own, never the JAX package's; under a
    launcher each local rank writes its own pidfile, and ``reclaim_chip``
    ends every rank;
  * ``maybe_clear_caches`` acts only from its RSS bound up.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from gnn_pretraining_tpu.utils import runtime as jax_runtime
from gnn_pretraining_tpu_torch.utils import runtime

REPO = Path(__file__).resolve().parent.parent
SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]


def spawn(cmd=SLEEPER) -> subprocess.Popen:
    return subprocess.Popen(cmd)


def dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


@pytest.mark.parametrize("recorded", ["pid", "pid start"])
def test_reclaim_chip_kills_the_recorded_process(tmp_path, recorded):
    pidfile = tmp_path / "sweep.pid"
    proc = spawn()
    try:
        start = runtime._proc_stat(proc.pid)[1]
        pidfile.write_text(str(proc.pid) if recorded == "pid" else f"{proc.pid} {start}")
        assert runtime.reclaim_chip(pidfile, wait_s=10.0)
        assert proc.wait(timeout=15) != 0
        assert not pidfile.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


STALE = {
    "absent": lambda proc: None,
    "garbage": lambda proc: "not-a-pid",
    "dead": lambda proc: str(dead_pid()),
    "recycled": lambda proc: f"{proc.pid} {runtime._proc_stat(proc.pid)[1] + 12345}",
    "legacy_not_python": lambda proc: str(proc.pid),
}


@pytest.mark.parametrize("case", sorted(STALE))
def test_a_stale_pidfile_is_removed_and_nothing_signalled(tmp_path, case):
    """Both packages refuse alike: an absent, garbled or dead file, a PID
    recycled since (start time differs), a legacy PID-only file of a process
    that is not python."""
    proc = spawn(["sleep", "60"] if case == "legacy_not_python" else SLEEPER)
    try:
        for rt in (runtime, jax_runtime):
            pidfile = tmp_path / f"{rt.__name__}.pid"
            text = STALE[case](proc)
            if text is not None:
                pidfile.write_text(text)
            assert not rt.reclaim_chip(pidfile, wait_s=5.0), rt.__name__
            assert not pidfile.exists()
        assert proc.poll() is None                  # untouched
    finally:
        proc.kill()
        proc.wait()


def test_write_pidfile_records_self_as_the_jax_package_does(tmp_path):
    port, jax = tmp_path / "port.pid", tmp_path / "jax.pid"
    runtime.write_pidfile(port)
    jax_runtime.write_pidfile(jax)
    pid, start = port.read_text().split()
    assert int(pid) == os.getpid()
    assert int(start) == runtime._proc_stat(os.getpid())[1]
    assert port.read_text() == jax.read_text()


def test_reclaim_chip_zombie_counts_as_exited(tmp_path):
    """An unreaped child has released the card: reclaim returns at once."""
    pidfile = tmp_path / "sweep.pid"
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.monotonic() + 10
    while runtime._proc_stat(proc.pid)[0] != "Z":
        assert time.monotonic() < deadline, "child never became a zombie"
        time.sleep(0.05)
    try:
        pidfile.write_text(f"{proc.pid} {runtime._proc_stat(proc.pid)[1]}")
        t0 = time.monotonic()
        assert runtime.reclaim_chip(pidfile, wait_s=30.0)
        assert time.monotonic() - t0 < 5.0
        assert not pidfile.exists()
    finally:
        proc.wait()


REQUESTER = """
import sys, time
from pathlib import Path
from gnn_pretraining_tpu_torch.utils import runtime
runtime.PAUSE_FILE, runtime.PAUSED_FILE = Path(sys.argv[1]), Path(sys.argv[2])
got = runtime.acquire_chip(Path(sys.argv[3]), wait_s=30.0, poll=0.05)
print("acquired", got, runtime.PAUSED_FILE.read_text(), flush=True)
time.sleep(0.5)
runtime.release_chip()
"""


def test_pause_handshake_with_a_requester_process(tmp_path, monkeypatch, capsys):
    """A requester asks while the sweep holds the card; the orchestrator
    parks at its boundary (the paused file names it), the requester gets the
    card, releases it, and the sweep resumes with both files gone."""
    pause, paused, holder = tmp_path / "s.pause", tmp_path / "s.paused", tmp_path / "s.pid"
    monkeypatch.setattr(runtime, "PAUSE_FILE", pause)
    monkeypatch.setattr(runtime, "PAUSED_FILE", paused)
    runtime.write_pidfile(holder)                   # a live holder: no early return
    requester = subprocess.Popen(
        [sys.executable, "-c", REQUESTER, str(pause), str(paused), str(holder)],
        stdout=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        deadline = time.monotonic() + 30
        while not pause.exists():
            assert time.monotonic() < deadline and requester.poll() is None
            time.sleep(0.05)
        t0 = time.monotonic()
        runtime.honor_pause("cells 2-2")
        parked_s = time.monotonic() - t0
        out, _ = requester.communicate(timeout=30)
    finally:
        if requester.poll() is None:
            requester.kill()
            requester.wait()
    assert requester.returncode == 0
    assert "[runtime] sweep parked at a chunk boundary" in out
    acquired = [line.split() for line in out.splitlines() if line.startswith("acquired")]
    assert acquired == [["acquired", "True", str(os.getpid()), str(runtime._identity().split()[1]),
                         "cells", "2-2"]]
    assert 0.4 < parked_s < 10.0
    printed = capsys.readouterr().out
    assert "sweep parked at cells 2-2" in printed and "sweep resuming" in printed
    assert not pause.exists() and not paused.exists()


def test_a_dead_requesters_pause_file_is_discarded(tmp_path, monkeypatch):
    """Gone (dead PID) or recycled (start time differs): neither package
    parks on it, and the file is removed."""
    me = runtime._proc_stat(os.getpid())[1]
    for owner in (f"{dead_pid()} 1", f"{os.getpid()} {me + 1}"):
        for rt in (runtime, jax_runtime):
            pause, paused = tmp_path / "x.pause", tmp_path / "x.paused"
            monkeypatch.setattr(rt, "PAUSE_FILE", pause)
            monkeypatch.setattr(rt, "PAUSED_FILE", paused)
            pause.write_text(owner)
            t0 = time.monotonic()
            rt.honor_pause()
            assert time.monotonic() - t0 < 1.0, rt.__name__
            assert not pause.exists() and not paused.exists()


def test_the_ports_files_are_its_own():
    port = {runtime.SWEEP_PIDFILE, runtime.PAUSE_FILE, runtime.PAUSED_FILE}
    jax = {jax_runtime.SWEEP_PIDFILE, jax_runtime.PAUSE_FILE, jax_runtime.PAUSED_FILE}
    assert len(port) == 3 and not port & jax
    assert not {p.name for p in port} & {p.name for p in jax}
    assert all(p.name.startswith("gnn_torch_sweep.") for p in port)


@pytest.mark.parametrize("rss,fires", [(0.5, False), (1.0, True)], ids=["below", "at"])
def test_maybe_clear_caches_acts_from_its_bound_up(monkeypatch, rss, fires):
    assert 0.0 < runtime.rss_gb() == pytest.approx(jax_runtime.rss_gb(), rel=0.05)
    collected = []
    monkeypatch.setattr(runtime, "rss_gb", lambda: rss * runtime.CLEAR_CACHES_RSS_GB)
    monkeypatch.setattr(runtime.gc, "collect", lambda: collected.append(1))
    assert runtime.maybe_clear_caches() is fires
    assert bool(collected) is fires


RANK_SWEEPER = ("import sys, time\n"
                "from gnn_pretraining_tpu_torch.utils import runtime\n"
                "runtime.write_pidfile(); time.sleep(60)")


def test_each_local_rank_has_its_pidfile_and_reclaim_ends_them_all(tmp_path):
    """Two processes under a launcher's environment (``LOCAL_RANK`` 0 and 1,
    the temporary directory ``tmp_path``) each record themselves in their
    own file beside ``SWEEP_PIDFILE``; ``reclaim_chip`` on the sweep's
    pidfile finds and terminates both."""
    env = dict(os.environ, TMPDIR=str(tmp_path), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SWEEPER],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    base = tmp_path / runtime.SWEEP_PIDFILE.name
    try:
        files = [tmp_path / f"gnn_torch_sweep.{r}.pid" for r in range(2)]
        deadline = time.monotonic() + 60
        while not all(f.exists() and f.read_text() for f in files):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.05)
        assert not base.exists()
        assert runtime.pidfiles(base) == files
        assert [int(f.read_text().split()[0]) for f in files] == [p.pid for p in procs]
        assert runtime.reclaim_chip(base, wait_s=10.0)
        assert all(p.wait(timeout=15) != 0 for p in procs)
        assert not any(f.exists() for f in files)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
