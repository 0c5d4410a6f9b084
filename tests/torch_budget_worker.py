"""A rank of ``tests/test_torch_budget.py``'s real 2-process gloo run: the budget's
program (``parallel/budget.build_program``) on random CPU leaves, its applying
micro-step run once; rank 0 prints the collectives it issued as one JSON line.
Imports no JAX. Usage: RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT set, argv[1] the
program's keywords as JSON."""

import json
import sys

import torch

from projectiontrainer_tpu_torch.parallel import budget, distributed


def main() -> None:
    kw = json.loads(sys.argv[1])
    distributed.initialize("cpu", backend="gloo", timeout_s=120)
    try:
        distributed.setup_mesh(distributed.world_size(), 1)
        program = budget.build_program(budget.small_test_config(), torch.device("cpu"),
                                       fake=False, **kw)
        ran = budget.run_tracked(program, budget.MemoryTracker())
        if distributed.rank() == 0:
            print("COLLECTIVES " + json.dumps(ran["collectives"]), flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
