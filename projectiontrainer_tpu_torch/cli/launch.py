"""Data-parallel launch: one process per GPU for every training stage.

Counterpart of ``projectiontrainer_tpu/cli/launch.py``. The JAX package runs one process
per host that owns the host's chips; the port runs one process per GPU, joined by
``torch.distributed`` (``parallel/distributed.py``), as ``torchrun`` does. Three ways:

1. **One node** - ``--nproc_per_node`` processes (default: one per visible GPU), one GPU
   each, over NCCL:

       projectiontrainer-torch-launch --nproc_per_node 8 stage1 -- --train_json ...

2. **Several nodes** - the same command on every node, with the JAX launcher's flags
   counting hosts (rank = ``process_id`` x ``nproc_per_node`` + local rank):

       projectiontrainer-torch-launch --coordinator node0:29500 --num_processes 2 \\
           --process_id $NODE --nproc_per_node 8 stage1 -- --train_json ...

3. **Local simulation** - ``--simulate N`` CPU processes over gloo on this machine (the
   stage runs with ``--device cpu``): a dry run of a data-parallel config without a GPU:

       projectiontrainer-torch-launch --simulate 2 stage1 -- --train_json ...

   ``--devices_per_host M`` beside it starts N x M ranks: the JAX launcher's M XLA CPU
   devices on each of N simulated hosts, as the port's one process a device (each
   simulated host's M ranks share its ``LOCAL_WORLD_SIZE``). Without ``--simulate`` it
   raises: the JAX launcher reads it in simulation only.

``--backend`` (nccl or gloo) is printed at start-up and never switched silently. NCCL
refuses two ranks on one GPU, so more ranks than GPUs needs an explicit ``--backend
gloo``, which then carries the CUDA tensors through host memory. ``--timeout`` bounds
every collective (a rank that never arrives fails the run instead of hanging it).

Each rank writes its output to a file under ``--log_dir`` (default: a new temporary
directory), not to a pipe: ranks block at collectives waiting for each other, and a rank
whose pipe filled while the launcher drained another would hang the run. Once every
rank has ended the launcher prints each log, its lines prefixed ``[rank i]``; when a
rank fails it stops the others and exits with that rank's exit code. A process that a
launcher started (``RANK``/``WORLD_SIZE`` set) runs its stage: ``torchrun ... -m
projectiontrainer_tpu_torch.cli.launch stage1 -- ...`` works too.

Feeder sizing: ``--feeder_procs auto`` (default) sizes the host's decode+augment worker
processes to ``min(cores - 2, 4 x local ranks)``; each rank takes its share
(``train/common.py:init_world`` divides by the local ranks). The value is injected as
``--num_loader_procs`` unless the stage args already set it.

``--entry module:function`` runs ``function(stage_argv)`` in every rank in place of a
named stage (a harness that builds its model inside the rank).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from projectiontrainer_tpu_torch.parallel import distributed

# stage name -> cli module with main(argv) (all parse reference-compatible flags)
STAGES = {
    "stage0": "projectiontrainer_tpu_torch.cli.train_stage0",
    "stage1": "projectiontrainer_tpu_torch.cli.train_stage1",
    "stage2": "projectiontrainer_tpu_torch.cli.train_stage2",
    "cls": "projectiontrainer_tpu_torch.cli.cls_train",
    "experiments": "projectiontrainer_tpu_torch.cli.run_experiments",
}


def _split_argv(argv):
    """Launcher args before the stage name; stage args after (optionally '--'). Without
    a stage name (``--entry``), the stage args follow '--'."""
    for i, a in enumerate(argv):
        if a in STAGES:
            rest = argv[i + 1:]
            if rest[:1] == ["--"]:
                rest = rest[1:]
            return argv[:i], a, rest
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], None, argv[i + 1:]
    return argv, None, []


def _auto_feeder_procs(local_ranks: int) -> int:
    cores = len(os.sched_getaffinity(0))
    return max(0, min(cores - 2, 4 * local_ranks))


def _inject_feeder(stage_argv: list[str], feeder: str, local_ranks: int = 1) -> list[str]:
    if feeder == "keep" or any(a.startswith("--num_loader_procs") for a in stage_argv):
        return stage_argv
    n = _auto_feeder_procs(local_ranks) if feeder == "auto" else int(feeder)
    return stage_argv + ["--num_loader_procs", str(n)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    """SIGTERM every rank still running, SIGKILL those alive 10 s later."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait(procs) -> int:
    """0 once every rank exits 0; the first failing rank's exit code, the others
    stopped, as soon as one fails."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            _stop(procs)
            return failed[0]
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.2)


def _spawn(args, stage, stage_argv, *, nproc: int, node: int, nodes: int, master: str,
           backend: str, per_host: int | None = None) -> int:
    """Start ranks ``node * nproc ... + nproc - 1`` of a world of ``nodes * nproc``, wait
    for them, print their logs; returns the exit code. ``per_host``: the ranks of one
    simulated host (``LOCAL_WORLD_SIZE``; default all ``nproc``)."""
    per_host = per_host or nproc
    logdir = args.log_dir or tempfile.mkdtemp(prefix="ptt_launch_")
    os.makedirs(logdir, exist_ok=True)
    addr, _, port = master.rpartition(":")
    world = nodes * nproc
    print(f"launch: node {node}/{nodes}, {nproc} rank(s) of {world}, backend={backend}, "
          f"master {addr}:{port}, logs in {logdir}", flush=True)
    env = dict(os.environ)
    # the ranks import this package also when it is run from a checkout
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(MASTER_ADDR=addr, MASTER_PORT=port, WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(per_host), PTT_DIST_BACKEND=backend)
    if args.timeout:
        env["PTT_DIST_TIMEOUT_S"] = str(args.timeout)
    if nodes == 1:  # the master is this host: keep the bootstrap sockets on the loopback
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if args.simulate:
        env["CUDA_VISIBLE_DEVICES"] = ""
        env.setdefault("OMP_NUM_THREADS", "1")
        env.setdefault("TOKENIZERS_PARALLELISM", "false")
    head = ["--entry", args.entry] if stage is None else [stage]
    procs, logs, files = [], [], []
    try:
        for local in range(nproc):
            rank = node * nproc + local
            path = os.path.join(logdir, f"rank{rank}.log")
            logs.append((rank, path))
            files.append(open(path, "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "projectiontrainer_tpu_torch.cli.launch", *head, "--",
                 *stage_argv],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(local % per_host)},
                stdout=files[-1], stderr=subprocess.STDOUT))
        rc = _wait(procs)
    finally:
        _stop(procs)
        for f in files:
            f.close()
    for rank, path in logs:
        with open(path) as f:
            for line in f:
                print(f"[rank {rank}] {line.rstrip()}")
    return rc


def _run_rank(stage, entry, stage_argv):
    """This process is one rank: run its stage (the CLI joins the process group)."""
    print(f"launch: rank {os.environ['RANK']}/{os.environ['WORLD_SIZE']}, local rank "
          f"{distributed.local_rank()}/{distributed.local_world_size()}, backend="
          f"{os.environ.get('PTT_DIST_BACKEND', 'default')}", flush=True)
    if stage is not None:
        fn = importlib.import_module(STAGES[stage]).main
    else:
        module, _, name = entry.partition(":")
        fn = getattr(importlib.import_module(module), name)
    try:
        result = fn(stage_argv)
    finally:
        distributed.shutdown()
    if isinstance(result, dict):
        print(f"launch: rank {os.environ['RANK']} result "
              f"{json.dumps(result, default=str, sort_keys=True)}", flush=True)


def main(argv=None) -> None:
    """Run the launcher; a failed rank raises ``SystemExit`` with its exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
        usage="projectiontrainer-torch-launch [options] "
              f"{{{','.join(STAGES)}}} -- <stage args>",
    )
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="ranks on this node (default: one per visible GPU)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of node 0 (several nodes)")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="nodes in the run, each running this command")
    parser.add_argument("--process_id", type=int, default=0,
                        help="this node's index in [0, num_processes)")
    parser.add_argument("--simulate", type=int, default=0, metavar="N",
                        help="N CPU processes over gloo on this machine (dry run, no GPU)")
    parser.add_argument("--devices_per_host", type=int, default=None, metavar="M",
                        help="with --simulate N: M CPU ranks on each of the N simulated "
                             "hosts (N x M ranks in all)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="the process group's backend (default: nccl; gloo under "
                             "--simulate)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds a collective may wait for a rank (default 600)")
    parser.add_argument("--log_dir", default=None,
                        help="directory of the ranks' logs (default: a new temp dir)")
    parser.add_argument("--feeder_procs", default="auto",
                        help="'auto' (size to host cores/ranks), 'keep' (leave stage "
                             "default), or an integer per-host worker count")
    parser.add_argument("--entry", default=None, metavar="MODULE:FUNCTION",
                        help="run FUNCTION(stage args) of MODULE in every rank instead of "
                             "a named stage")
    launcher_argv, stage, stage_argv = _split_argv(argv)
    args = parser.parse_args(launcher_argv)
    if (stage is None) == (args.entry is None):
        parser.error(f"give one stage (one of {', '.join(STAGES)}) or --entry")

    if distributed.launched():  # a rank: run the stage
        _run_rank(stage, args.entry, stage_argv)
        return

    if args.devices_per_host is not None and (not args.simulate or args.devices_per_host < 1):
        parser.error("--devices_per_host M takes --simulate N (N x M CPU ranks) and M >= 1")
    if args.simulate:
        if args.backend == "nccl" or args.coordinator or args.num_processes != 1:
            parser.error("--simulate runs one node of CPU processes over gloo")
        if "--device" in stage_argv and stage_argv[stage_argv.index("--device") + 1] != "cpu":
            parser.error("--simulate runs the stage on the CPU (--device cpu)")
        if "--device" not in stage_argv:
            stage_argv = stage_argv + ["--device", "cpu"]
        nproc = args.simulate * (args.devices_per_host or 1)
        backend, master = "gloo", f"127.0.0.1:{_free_port()}"
    else:
        import torch

        nproc = args.nproc_per_node or torch.cuda.device_count()
        if nproc < 1:
            parser.error("no GPU visible: pass --nproc_per_node N (with --backend gloo for "
                         "ranks that share a card) or --simulate N for a CPU dry run")
        backend = args.backend or "nccl"
        distributed.check_backend(backend, "cuda", nproc)
        if args.num_processes > 1 and not args.coordinator:
            parser.error("several nodes need --coordinator host:port (node 0's)")
        master = args.coordinator or f"127.0.0.1:{_free_port()}"
    per_host = args.devices_per_host if args.simulate else None
    stage_argv = _inject_feeder(stage_argv, args.feeder_procs, per_host or nproc)
    # a SIGTERM to the launcher stops the ranks too (_spawn's finally)
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        rc = _spawn(args, stage, stage_argv, nproc=nproc, node=args.process_id,
                    nodes=args.num_processes, master=master, backend=backend,
                    per_host=per_host)
    finally:
        signal.signal(signal.SIGTERM, previous)
    if rc:
        raise SystemExit(rc)


if __name__ == "__main__":
    sys.exit(main())
