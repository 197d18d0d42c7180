"""Subprocesses of the multi-rank tests (tests/test_torch_mesh.py): the
port's ranks under ``torch.distributed.run`` and JAX with virtual CPU
devices, each writing its output to a log file, each waited for with a
timeout of its own, so that a hung collective fails one test."""
import os
import signal
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
TIMEOUT = 600


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _popen(cmd, log: str, env) -> subprocess.Popen:
    """``cmd`` leading a new process group (so that a timeout can kill the
    ranks that ``torch.distributed.run`` starts too), its output to ``log``."""
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True, env=env,
                             process_group=0)
    p.log = log
    return p


def torch_ranks(out: str, n: int = 8) -> subprocess.Popen:
    """The worker on ``n`` gloo ranks (a free port: --standalone)."""
    return _popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc-per-node={n}", WORKER, out],
                  os.path.join(out, "ranks.log"), _env(OMP_NUM_THREADS="1"))


def python_sub(code: str, log: str, devices: int = 0, **env) -> subprocess.Popen:
    """Python code in a subprocess, its output to ``log``; with ``devices``,
    JAX sees that many CPU devices."""
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return _popen([sys.executable, "-c", textwrap.dedent(code)], log, _env(**env))


def finish(p: subprocess.Popen, timeout: float = TIMEOUT) -> str:
    """Waits for ``p`` (killed after ``timeout`` s) and returns its output;
    fails on a non-zero exit."""
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    with open(p.log) as f:
        out = f.read()
    assert p.returncode == 0, f"exit {p.returncode}:\n{out[-8000:]}"
    return out


def stop(*ps: subprocess.Popen) -> None:
    """Kill whatever of ``ps`` still runs (a fixture that failed midway)."""
    for p in ps:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
