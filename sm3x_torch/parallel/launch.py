"""Start N processes of one command on this machine, as torchrun would:
each gets RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (a free
port on 127.0.0.1), so `distributed_initialize()` joins them. Used by
tools/dryrun_multigpu_torch.py, the tests and chip_smoke.py."""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(cmd, nprocs: int, timeout: float, env=None,
                 cwd=None, live: bool = False) -> list:
    """Run `cmd` (an argv list) as ranks 0 .. nprocs - 1 and wait for all;
    returns [(exit code, output)] by rank, stdout and stderr together
    (with `live`, rank 0 writes to this process's stdout as it goes, and
    its output here is empty). Where one rank fails, or the time runs out,
    every rank still running is killed (exit code -9) and its output so
    far is returned."""
    base = dict(os.environ if env is None else env,
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nprocs))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
    procs = [subprocess.Popen(
        cmd, cwd=cwd, stdout=None if live and r == 0 else log,
        stderr=None if live and r == 0 else subprocess.STDOUT, text=True,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break   # out of time, or a rank failed: stop the rest
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]
