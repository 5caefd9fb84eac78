"""The time limits of the port's multi-process tests.

Each process of a harness, the reference's JAX subprocess or a world of
gloo ranks, runs under a limit of its own, counted from its own start. One
that runs over is killed, and the test fails naming it, with the end of
what it printed (a rank's output goes to a file of its own, ``rank<r>.log``
beside its record). A rank that raises fails the test with its traceback.

The limits are sized from the fixtures' times under the tier-1 run's load
(``pytest -n 6 --dist loadfile``: up to six of these harnesses side by
side on 8 cores; 106 to 254 s a fixture, reference and worlds together),
at about two to three times a process's share of them.
"""
import os
import subprocess
import time

import numpy as np
import pytest

TAIL = 4000                 # characters of a process's output in a failure


def _tail(path) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-TAIL:]
    except OSError:
        return "(no output)"


class Reference:
    """A subprocess (the reference, in JAX, or a fake world's rank)
    started now in ``cwd``, its output to ``log``; ``wait`` holds it to
    ``limit_s`` from its start."""

    def __init__(self, name: str, argv: list, env: dict, log, limit_s: float,
                 cwd=None) -> None:
        self.name, self.log, self.limit_s = name, log, limit_s
        self.started = time.monotonic()
        with open(log, "w") as out:
            self.proc = subprocess.Popen(argv, env=env, cwd=cwd, stdout=out,
                                         stderr=subprocess.STDOUT, text=True)

    def wait(self) -> None:
        """Waits for it; fails if it runs past its limit or exits
        nonzero."""
        left = self.started + self.limit_s - time.monotonic()
        try:
            self.proc.wait(timeout=max(left, 0.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            pytest.fail(f"{self.name} ran past its {self.limit_s} s; its "
                        f"output ends:\n{_tail(self.log)}")
        if self.proc.returncode != 0:
            took = time.monotonic() - self.started
            pytest.fail(f"{self.name} failed (exit {self.proc.returncode}) "
                        f"after {took:.1f} s:\n{_tail(self.log)}")


def run_reference(name: str, argv: list, env: dict, log, limit_s: float
                  ) -> None:
    """``Reference(...).wait()``."""
    Reference(name, argv, env, log, limit_s).wait()


def _logged(rank: int, fn, log_dir: str, *args) -> None:
    """``fn(rank, *args)`` with this process's output to its own log."""
    fd = os.open(os.path.join(log_dir, f"rank{rank}.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    fn(rank, *args)


class World:
    """``fn(rank, *args)`` on ``world`` gloo processes (spawned), started
    now; each writes ``rank<r>.npz`` into ``out_dir``. ``join`` holds them
    to ``limit_s`` from their start."""

    def __init__(self, name: str, fn, world: int, args: tuple, out_dir,
                 limit_s: float) -> None:
        import torch.multiprocessing as mp
        self.name, self.world, self.out_dir = name, world, out_dir
        self.limit_s = limit_s
        self.started = time.monotonic()
        self.ctx = mp.start_processes(
            _logged, args=(fn, str(out_dir), *args), nprocs=world,
            join=False, start_method="spawn")

    def join(self) -> list[dict]:
        """Each rank's record; fails if a rank raises (with its
        traceback) or the world runs past its limit (naming it, with each
        rank's output)."""
        while not self.ctx.join(timeout=2):
            if time.monotonic() > self.started + self.limit_s:
                for proc in self.ctx.processes:
                    proc.kill()
                logs = "\n".join(
                    f"--- rank {r}:\n{_tail(self.out_dir / f'rank{r}.log')}"
                    for r in range(self.world))
                pytest.fail(f"{self.name} ({self.world} gloo ranks) ran past "
                            f"its {self.limit_s} s; their output ends:\n"
                            f"{logs}")
        return [dict(np.load(self.out_dir / f"rank{r}.npz"))
                for r in range(self.world)]
