"""The parameter server's closed-form check: one script, server or
worker by role.

Counterpart of ``tests/nightly/dist_sync_kvstore.py`` (reference
tests/nightly/dist_sync_kvstore.py), on the port. Each worker pushes
(rank + 1) times ones to keys 3 (4 x 4) and 9 (1200 x 1200: over the
1 M-element bound, so split across the servers when there are several)
under the Test optimizer (w += rescale * merged), ``ROUNDS`` rounds: after
round r every pull must read r * sum(rank + 1) exactly. Then a second
store, ``dist_async``, on the same servers (a new store of a live job is
welcomed, not taken for a recovery, so its mode is applied): one push a
worker, applied at once, read back exactly after a barrier. The values
live on ``--device`` (the card by default, "cpu" on the host).

    python tools/launch.py -n 2 -s 2 --launcher local \\
        python -m mxnet_tpu_torch.tools.dist_sync_kvstore

Prints one JSON line a worker (its checks and the kvstore counters).
"""
from __future__ import annotations

import argparse
import json
import os
import time

SHAPES = {3: (4, 4), 9: (1200, 1200)}
ROUNDS = 3


def _counters():
    from mxnet_tpu_torch import telemetry

    return {n: v for n, v in telemetry.registry.get_name_value()
            if n.startswith("kvstore_")}


def worker(device):
    import numpy as np

    import mxnet_tpu_torch as mt

    rank = int(os.environ["MXNET_TPU_WORKER_RANK"])
    n = int(os.environ["MXNET_TPU_NUM_WORKERS"])
    kv = mt.kvstore.create("dist_sync")
    assert kv.num_workers == n and kv.rank == rank, (kv.num_workers, kv.rank)
    kv.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
    for key, shape in SHAPES.items():
        kv.init(key, mt.nd.zeros(shape, device))
    scale = sum(r + 1 for r in range(n))
    checked = 0
    for rnd in range(1, ROUNDS + 1):
        for key, shape in SHAPES.items():
            kv.push(key, mt.nd.ones(shape, device) * (rank + 1))
        kv.barrier()
        for key, shape in SHAPES.items():
            out = mt.nd.zeros(shape, device)
            kv.pull(key, out=out)
            got = out.asnumpy()
            want = np.full(shape, float(rnd * scale), np.float32)
            if not np.array_equal(got, want):
                raise AssertionError("rank %d key %s round %d: %s, want %s"
                                     % (rank, key, rnd, got.flat[:4],
                                        want.flat[:4]))
            checked += 1
        kv.barrier()
    kv.close()

    # a second store of the same job: asynchronous
    akv = mt.kvstore.create("dist_async")
    akv.barrier()  # rank 0 has announced the mode
    for key, shape in SHAPES.items():
        akv.push(key, mt.nd.ones(shape, device) * (rank + 1))
    akv.barrier()
    for key, shape in SHAPES.items():
        out = mt.nd.zeros(shape, device)
        akv.pull(key, out=out)
        want = np.full(shape, float((ROUNDS + 1) * scale), np.float32)
        if not np.array_equal(out.asnumpy(), want):
            raise AssertionError("rank %d key %s async: %s, want %s"
                                 % (rank, key, out.asnumpy().flat[:4],
                                    want.flat[:4]))
        checked += 1
    akv.barrier()
    counters = _counters()
    akv.stop_server()
    return {"rank": rank, "workers": n, "rounds": ROUNDS,
            "shapes": {str(k): list(v) for k, v in SHAPES.items()},
            "exact_checks": checked, "device": str(out.context),
            "counters": counters, "ok": True}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    main_at = time.time()
    from mxnet_tpu_torch import kvstore_server

    if kvstore_server.maybe_run_server_by_role():
        return 0
    res = worker(args.device)
    res.update(main_at=main_at, done_at=time.time())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
