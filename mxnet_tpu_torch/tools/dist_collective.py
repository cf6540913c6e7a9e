"""The collective runtime's check: n ranks form one process group.

Counterpart of ``tests/nightly/dist_collective.py``, on the port:
``parallel.dist.init()`` from the launcher's environment, then
``dist.size()`` is n and an all-gather returns each rank's (rank + 1) in
rank order; then the collective ``dist_sync`` kvstore in closed form:
each rank pushes (rank + 1) times ones to keys 3 (4 x 4) and 9
(1200 x 1200) under the Test optimizer, ``ROUNDS`` rounds, and reads
r * sum(rank + 1) exactly after round r; ``dist_async`` (which the
collective store runs as ``dist_sync``, as the JAX package's does) one
round more. ``--backend`` names the group's backend (default: nccl on the
card, gloo with ``--device cpu``).

    python tools/launch.py -n 2 --launcher local \\
        python -m mxnet_tpu_torch.tools.dist_collective --device cpu

Prints one JSON line a rank.
"""
from __future__ import annotations

import argparse
import json
import time

SHAPES = {3: (4, 4), 9: (1200, 1200)}
ROUNDS = 3


def worker(device, backend):
    import numpy as np
    import torch
    import torch.distributed as td

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import dist

    dist.init(backend=backend, device=device)
    n, rank = dist.size(), dist.rank()
    dev = mt.nd.zeros((1,), device).context
    mine = torch.full((1,), rank + 1.0, device=dev)
    got = [torch.zeros_like(mine) for _ in range(n)]
    td.all_gather(got, mine)
    gathered = [float(g.item()) for g in got]
    assert gathered == [r + 1.0 for r in range(n)], gathered
    dist.barrier()
    scale = sum(r + 1 for r in range(n))
    checked = 0
    for kind, rounds, first in (("dist_sync", ROUNDS, 1),
                                ("dist_async", 1, ROUNDS + 1)):
        kv = mt.kvstore.create(kind)
        assert kv.num_workers == n and kv.rank == rank
        kv.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
        for key, shape in SHAPES.items():
            kv.init(key, mt.nd.full(shape, (first - 1) * scale, device))
        for rnd in range(first, first + rounds):
            for key, shape in SHAPES.items():
                kv.push(key, mt.nd.ones(shape, device) * (rank + 1))
            kv.barrier()
            for key, shape in SHAPES.items():
                out = mt.nd.zeros(shape, device)
                kv.pull(key, out=out)
                want = np.full(shape, float(rnd * scale), np.float32)
                if not np.array_equal(out.asnumpy(), want):
                    raise AssertionError(
                        "rank %d %s key %s round %d: %s, want %s"
                        % (rank, kind, key, rnd, out.asnumpy().flat[:4],
                           want.flat[:4]))
                checked += 1
    backend_used = dist.backend()
    dist.shutdown()
    return {"rank": rank, "size": n, "backend": backend_used,
            "allgather": gathered, "exact_checks": checked,
            "device": str(dev), "ok": True}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--backend", default=None)
    args = parser.parse_args(argv)
    main_at = time.time()
    res = worker(args.device, args.backend)
    res.update(main_at=main_at, done_at=time.time())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
