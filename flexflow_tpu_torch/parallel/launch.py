"""Run a job on N ranks, one process each, on one host.

``run_ranks("module:function", n, payload, workdir=...)`` (or
``"path/to/file.py:function"``) starts n
processes of ``python -m flexflow_tpu_torch.parallel.launch``; each joins
the process group through a ``FileStore`` under ``workdir`` (no TCP port:
concurrent jobs on one host never race for one), calls
``function(payload)`` and writes its JSON-able result, which
``run_ranks`` returns in rank order. Every process and every collective
has a timeout: a rank that fails or hangs makes ``run_ranks`` kill the
others and raise with the failing rank's output, instead of blocking.

With ``device="cuda"`` all ranks share the visible cards (rank r on card
r mod count); the backend is chosen as ``distributed.choose_backend``
does (gloo when ranks share a card) unless ``backend`` is given.

torchrun is the other launcher: the serving entry points read its
environment (``distributed.initialize``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

_REPO = pathlib.Path(__file__).resolve().parents[2]


def run_ranks(target: str, world_size: int, payload: Dict[str, Any], *,
              workdir, timeout: float = 300.0, device: str = "cpu",
              backend: Optional[str] = None,
              env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``target`` ("module:function") on ``world_size`` ranks; returns
    each rank's result. Raises RuntimeError when a rank fails and
    TimeoutError when the job outlives ``timeout`` seconds."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    (work / "payload.json").write_text(json.dumps(payload))
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    child_env.pop("FF_DISABLE_DISTRIBUTED", None)
    if device == "cpu":
        # n ranks on a shared host: one thread each
        child_env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    logs = []
    for r in range(world_size):
        log = open(work / f"rank{r}.log", "w")
        logs.append(log)
        cmd = [sys.executable, "-m", "flexflow_tpu_torch.parallel.launch",
               "--target", target, "--rank", str(r), "--world-size",
               str(world_size), "--workdir", str(work), "--device", device,
               "--timeout", str(timeout)]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(cmd, cwd=str(_REPO), env=child_env,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{target} on {world_size} ranks outlived {timeout} s:"
                    f"\n{_tail(work, codes.index(None))}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        raise RuntimeError(f"{target}: rank {failed} exited with "
                           f"{procs[failed].returncode}:\n"
                           f"{_tail(work, failed)}")
    return [json.loads((work / f"result{r}.json").read_text())
            for r in range(world_size)]


def load_target(target: str):
    """The function ``target`` names: ``"module:function"`` or
    ``"path/to/file.py:function"``."""
    mod, fn = target.rsplit(":", 1)
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            pathlib.Path(mod).stem, mod)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod)
    return getattr(module, fn)


def _tail(work: pathlib.Path, rank: int, n: int = 6000) -> str:
    try:
        return (work / f"rank{rank}.log").read_text()[-n:]
    except OSError:
        return ""


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    from flexflow_tpu_torch import distributed

    work = pathlib.Path(args.workdir)
    os.environ["RANK"] = str(args.rank)
    os.environ["WORLD_SIZE"] = str(args.world_size)
    os.environ["LOCAL_RANK"] = str(args.rank)
    distributed.initialize(init_method=f"file://{work / 'store'}",
                           world_size=args.world_size, rank=args.rank,
                           backend=args.backend, device=args.device,
                           timeout=args.timeout)
    if args.device.startswith("cuda"):
        import torch

        torch.cuda.set_device(args.rank % torch.cuda.device_count())
    payload = json.loads((work / "payload.json").read_text())
    result = load_target(args.target)(payload)
    (work / f"result{args.rank}.json").write_text(json.dumps(result))
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    code = main()
    # the rank has written its result and left the process group: exit
    # without the interpreter's teardown, where torch's C++ threads can
    # abort a finished rank ("terminate called without an active
    # exception", exit -6; seen with gloo on a loaded host)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
