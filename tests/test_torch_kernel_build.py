"""``kernels.build`` under processes that start together: the ranks of a
cluster on one card.  ``nvcc`` and ``subprocess`` are stubbed, so this runs
without the CUDA toolkit; the stubs log each compile and link to a file."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r"""
import sys, time
from pathlib import Path
from safe_control_gym_torch import kernels as K

tmp, me = Path(sys.argv[1]), sys.argv[2]
K.BUILD = tmp / "build"
K.LIB = K.BUILD / "libscg_kernels.so"
K._nvcc = lambda: "nvcc"
log = tmp / "calls.log"


def record(what):
    with open(log, "a") as f:
        f.write(f"{me} {what}\n")


class Proc:
    returncode = 0

    def __init__(self, cmd, **kw):
        record("compile")
        time.sleep(0.1)  # widens the window in which an unlocked build races

    def communicate(self):
        return "", None


class Done:
    returncode, stdout, stderr = 0, "", ""


def run(cmd, **kw):
    Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
    record("link")
    return Done()


K.subprocess.Popen, K.subprocess.run = Proc, run
(tmp / f"ready.{me}").touch()
while len(list(tmp.glob("ready.*"))) < 2:  # both ranks build at once
    time.sleep(0.01)
print(K.build())
"""


def test_two_processes_build_once(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(tmp_path), str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    from safe_control_gym_torch import kernels

    lib = tmp_path / "build" / kernels.LIB.name
    assert all(o.strip().endswith(str(lib)) for o in outs), outs
    calls = (tmp_path / "calls.log").read_text().split("\n")[:-1]
    # One rank compiled every source and linked once; the other found the
    # stamp current once it held the lock.
    assert len(calls) == len(kernels.SOURCES) + 1, calls
    assert len({c.split()[0] for c in calls}) == 1, calls
    assert calls[-1].endswith("link")
    assert (tmp_path / "build" / "stamp").read_text() == kernels._stamp()
